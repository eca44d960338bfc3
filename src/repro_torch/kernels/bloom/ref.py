"""Plain PyTorch version of the Bloom probe kernel (same 32-bit math,
computed in int64)."""

from __future__ import annotations

import torch

from ..u32 import mix32, widen


def bloom_probe_ref(keys32: torch.Tensor, words: torch.Tensor, *,
                    m_bits: int, seeds) -> torch.Tensor:
    """keys32: (n,) folded u32 keys; words: (W,) u32 filter words, both
    int32 storage.  Returns int32 {0,1} (n,): does every seed's bit
    ``mix32(key, seed) % m_bits`` lie set?"""
    k = widen(keys32)
    w = widen(words)
    hit = torch.ones(k.shape, dtype=torch.bool, device=k.device)
    for seed in seeds:
        p = mix32(k, int(seed)) % int(m_bits)
        hit &= ((w[p >> 5] >> (p & 31)) & 1) == 1
    return hit.to(torch.int32)
