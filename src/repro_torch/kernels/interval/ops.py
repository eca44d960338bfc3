"""Wrappers of the interval point-stab kernels (``csrc/interval_sm90.cu``
and ``csrc/interval.cu``).

Replaces ``src/repro/kernels/interval/kernel.py::interval_query_pallas``.
A CPU tensor takes the plain version; a CUDA tensor launches
``interval_sm90`` (a thread a query over a shared-memory directory of
``lo``), one launch over the whole level, or raises.  The first
``interval`` kernel (a thread a query, binary search in global memory)
computes the same verdicts and is reached only through ``_launch_simt``,
so that both can be timed on the same inputs.
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
        return _launch_sm90(keys32, seqs32, lo, hi, smin, smax)


def _operands(name, keys32, seqs32, lo, hi, smin, smax):
    """Checked device, output, and the C arguments shared by both
    kernels."""
    n, m = keys32.numel(), lo.numel()
    if seqs32.numel() != n or not hi.numel() == smin.numel() \
            == smax.numel() == m or m >= 1 << 31:
        raise ValueError(f"{name}: {n} keys with {seqs32.numel()} seqs, "
                         f"columns of {m}, {hi.numel()}, {smin.numel()}, "
                         f"{smax.numel()} areas")
    dev = native.require_cuda(name, keys32, seqs32, lo, hi, smin, smax)
    out = torch.empty(n, dtype=torch.int32, device=dev)
    p = native.ptr
    args = [n, p(keys32), p(seqs32), m, p(lo), p(hi), p(smin), p(smax),
            p(out)]
    argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int] + [ctypes.c_void_p] * 5
    return dev, out, args, argtypes


def _launch_sm90(keys32, seqs32, lo, hi, smin, smax, *,
                 planted_fault: bool = False):
    """``interval_sm90``; ``planted_fault`` searches lower_bound (a wrong
    kernel, for the card's checks)."""
    dev, out, args, argtypes = _operands("interval_sm90", keys32, seqs32, lo,
                                         hi, smin, smax)
    fn = native.library("interval_sm90").interval_sm90_launch
    fn.argtypes = argtypes + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    native.check("interval_sm90", fn(*args, int(planted_fault),
                                     native.stream(dev)))
    native.count_launch("interval_sm90")
    return out


def _launch_simt(keys32, seqs32, lo, hi, smin, smax) -> torch.Tensor:
    """``interval``: a thread a query, binary search in global memory."""
    dev, out, args, argtypes = _operands("interval", keys32, seqs32, lo, hi,
                                         smin, smax)
    fn = native.library("interval").interval_launch
    fn.argtypes = argtypes + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    native.check("interval", fn(*args, native.stream(dev)))
    native.count_launch("interval")
    return out


def _launch_floor(n: int, device) -> None:
    """An empty kernel on ``interval_sm90``'s grid for n queries: the
    launch floor beneath its time (not a launch of the stab)."""
    dev = torch.device(device)
    fn = native.library("interval_sm90").interval_sm90_floor_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    native.check("interval_sm90_floor", fn(n, native.stream(dev)))
