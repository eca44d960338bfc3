"""Wrapper of the Bloom probe kernel (``csrc/bloom.cu``).

Replaces ``src/repro/kernels/bloom/kernel.py::bloom_probe_pallas``.  A
CPU tensor takes the plain version; a CUDA tensor launches the kernel,
one launch over the whole filter, or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...obs import span
from .. import native
from .ref import bloom_probe_ref


def bloom_probe(keys32: torch.Tensor, words: torch.Tensor, *, m_bits: int,
                seeds) -> torch.Tensor:
    """int32 {0,1} (n,) filter verdicts of folded u32 keys (int32
    storage) against one filter's u32 words, on the keys' device."""
    with span("kernel.bloom", n=int(keys32.numel())):
        if keys32.device.type == "cpu":
            return bloom_probe_ref(keys32, words, m_bits=m_bits,
                                   seeds=seeds)
        return _launch(keys32, words, int(m_bits), seeds)


def _launch(keys32, words, m_bits, seeds) -> torch.Tensor:
    dev = native.require_cuda("bloom", keys32, words)
    seeds_host = np.ascontiguousarray(
        [int(s) for s in seeds], dtype=np.uint32)
    n = keys32.numel()
    out = torch.empty(n, dtype=torch.int32, device=dev)
    fn = native.library("bloom").bloom_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_uint32, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(n, native.ptr(keys32), native.ptr(words), m_bits,
             seeds_host.ctypes.data_as(ctypes.c_void_p), len(seeds_host),
             native.ptr(out), native.stream(dev))
    native.check("bloom", err)
    native.count_launch("bloom")
    return out
