"""Wrapper of the interval point-stab kernel (``csrc/interval.cu``).

Replaces ``src/repro/kernels/interval/kernel.py::interval_query_pallas``.
A CPU tensor takes the plain version; a CUDA tensor launches the
kernel, one launch over the whole level, or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ...obs import span
from .. import native
from .ref import interval_query_ref


def interval_query(keys32, seqs32, lo, hi, smin, smax) -> torch.Tensor:
    """int32 {0,1} (n,): is (key, seq) covered by the disjoint level?"""
    with span("kernel.interval", n=int(keys32.numel()),
              areas=int(lo.numel())):
        if keys32.device.type == "cpu":
            return interval_query_ref(keys32, seqs32, lo, hi, smin, smax)
        return _launch(keys32, seqs32, lo, hi, smin, smax)


def _launch(keys32, seqs32, lo, hi, smin, smax) -> torch.Tensor:
    dev = native.require_cuda("interval", keys32, seqs32, lo, hi, smin,
                              smax)
    n = keys32.numel()
    out = torch.empty(n, dtype=torch.int32, device=dev)
    fn = native.library("interval").interval_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int] + [ctypes.c_void_p] * 6
    fn.restype = ctypes.c_int
    err = fn(n, native.ptr(keys32), native.ptr(seqs32), lo.numel(),
             native.ptr(lo), native.ptr(hi), native.ptr(smin),
             native.ptr(smax), native.ptr(out), native.stream(dev))
    native.check("interval", err)
    native.count_launch("interval")
    return out
