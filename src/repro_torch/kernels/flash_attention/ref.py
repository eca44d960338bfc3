"""Plain PyTorch version of the flash attention kernel
(``repro.kernels.flash_attention.ref.attention_ref``).

Causal over the suffix alignment (queries are the last ``q_len``
positions of the kv stream), optional sliding window (attend to
positions in (pos - window, pos]), GQA by head-group repetition, f32
math (f64 for f64 inputs), output in q's type; a row with no valid key
gives 0.
"""

from __future__ import annotations

import torch


def attention_ref(q, k, v, *, scale=None, causal=True, window=None):
    """q: (B, Sq, Hq, D); k/v: (B, Skv, Hkv, D) -> (B, Sq, Hq, D)."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    assert hq % hkv == 0
    group = hq // hkv
    if scale is None:
        scale = d ** -0.5
    f = torch.promote_types(q.dtype, torch.float32)
    kr = torch.repeat_interleave(k, group, dim=2)
    vr = torch.repeat_interleave(v, group, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(f), kr.to(f)) * scale
    q_pos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    k_pos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > (q_pos - window)
    s = torch.where(mask[None, None], s, -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = torch.where(mask[None, None], p, 0.0)
    denom = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(denom == 0.0, 1.0, denom)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vr.to(f))
    return o.to(q.dtype)
