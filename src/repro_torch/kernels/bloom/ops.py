"""Wrappers of the Bloom probe kernels (``csrc/bloom_sm90.cu`` and
``csrc/bloom.cu``).

Replaces ``src/repro/kernels/bloom/kernel.py::bloom_probe_pallas``.  A
CPU tensor takes the plain version; a CUDA tensor launches
``bloom_sm90`` (a thread a key), one launch over the whole filter, or
raises.  The first ``bloom`` kernel (a thread a key that stops at its
first unset bit) computes the same verdicts and is reached only through
``_launch_simt``, so that both can be timed on the same inputs.
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
        return _launch_sm90(keys32, words, m_bits, seeds)


def _operands(name, keys32, words, m_bits, seeds):
    """Checked device, seeds on the host, output, and the leading C
    arguments shared by both kernels."""
    m_bits = int(m_bits)
    if not 0 < m_bits < 1 << 32 or words.numel() * 32 < m_bits:
        raise ValueError(f"{name}: m_bits {m_bits} outside [1, 2^32) or "
                         f"past the filter's {words.numel()} words")
    dev = native.require_cuda(name, keys32, words)
    seeds_host = np.ascontiguousarray([int(s) for s in seeds],
                                      dtype=np.uint32)
    out = torch.empty(keys32.numel(), dtype=torch.int32, device=dev)
    args = [keys32.numel(), native.ptr(keys32), native.ptr(words), m_bits,
            seeds_host.ctypes.data_as(ctypes.c_void_p), len(seeds_host),
            native.ptr(out)]
    argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_uint32, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_void_p]
    return dev, seeds_host, out, args, argtypes


def _launch_sm90(keys32, words, m_bits, seeds, *,
                 planted_fault: bool = False):
    """``bloom_sm90``; ``planted_fault`` probes only the first H - 1
    seeds (a wrong kernel, for the card's checks)."""
    dev, seeds_host, out, args, argtypes = _operands(
        "bloom_sm90", keys32, words, m_bits, seeds)
    fn = native.library("bloom_sm90").bloom_sm90_launch
    fn.argtypes = argtypes + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    native.check("bloom_sm90", fn(*args, int(planted_fault),
                                  native.stream(dev)))
    native.count_launch("bloom_sm90")
    return out


def _launch_simt(keys32, words, m_bits, seeds) -> torch.Tensor:
    """``bloom``: a thread a key, the probes one after another."""
    dev, seeds_host, out, args, argtypes = _operands(
        "bloom", keys32, words, m_bits, seeds)
    fn = native.library("bloom").bloom_launch
    fn.argtypes = argtypes + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    native.check("bloom", fn(*args, native.stream(dev)))
    native.count_launch("bloom")
    return out


def _launch_floor(n: int, device) -> None:
    """An empty kernel on ``bloom_sm90``'s grid for n keys: the launch
    floor beneath its time (not a launch of the probe)."""
    dev = torch.device(device)
    fn = native.library("bloom_sm90").bloom_sm90_floor_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    native.check("bloom_sm90_floor", fn(n, native.stream(dev)))
