"""Wrapper of the Bloom probe kernel (``csrc/bloom_sm90.cu``).

Replaces ``src/repro/kernels/bloom/kernel.py::bloom_probe_pallas``.  A
CPU tensor takes the plain version; a CUDA tensor launches
``bloom_sm90`` (a thread a key), one launch over the whole filter, or
raises.
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


def _launch_sm90(keys32, words, m_bits, seeds, *,
                 planted_fault: bool = False):
    """``bloom_sm90``; ``planted_fault`` probes only the first H - 1
    seeds (a wrong kernel, for the card's checks)."""
    m_bits = int(m_bits)
    if not 0 < m_bits < 1 << 32 or words.numel() * 32 < m_bits:
        raise ValueError(f"bloom_sm90: m_bits {m_bits} outside [1, 2^32) "
                         f"or past the filter's {words.numel()} words")
    dev = native.require_cuda("bloom_sm90", keys32, words)
    seeds_host = np.ascontiguousarray([int(s) for s in seeds],
                                      dtype=np.uint32)
    out = torch.empty(keys32.numel(), dtype=torch.int32, device=dev)
    fn = native.entry("bloom_sm90", "bloom_sm90_launch")
    native.check("bloom_sm90", fn(
        keys32.numel(), native.ptr(keys32), native.ptr(words), m_bits,
        seeds_host.ctypes.data_as(ctypes.c_void_p), len(seeds_host),
        native.ptr(out), int(planted_fault), native.stream(dev)))
    native.count_launch("bloom_sm90")
    return out


def _launch_floor(n: int, device) -> None:
    """An empty kernel on ``bloom_sm90``'s grid for n keys: the launch
    floor beneath its time (not a launch of the probe)."""
    dev = torch.device(device)
    fn = native.entry("bloom_sm90", "bloom_sm90_floor_launch")
    native.check("bloom_sm90_floor", fn(n, native.stream(dev)))
