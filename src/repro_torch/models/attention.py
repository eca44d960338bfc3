"""GQA attention (causal / sliding-window / local-global) + KV cache.

Prefill and the forward pass over a sequence's own keys go through
``kernels/flash_attention`` (the CUDA kernel on a card, its plain
version on the CPU); decode against a cache, and the banded local path,
are plain torch, as the JAX package computes them outside any kernel.
``window`` is a Python int per layer (-1 = full attention).
"""

from __future__ import annotations

import torch

from ..kernels import sharded
from ..kernels.flash_attention.ops import flash_attention
from .layers import rope
from .sharding import ShardingRules, constrain, is_dtensor


def masked_attention(q, k, v, *, window: int, q_offset: int, lengths=None):
    """q: (B,Sq,Hq,D); k/v: (B,Skv,Hkv,D); window: int (-1 = full).

    Causal with suffix alignment: absolute query position = q_offset + i.
    ``lengths``: optional (B,) valid kv lengths (decode with a ragged
    cache).  With no cache (no lengths, q_offset 0, Sq == Skv) this is
    the flash kernel's function and goes through it.
    """
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    if lengths is None and q_offset == 0 and sq == skv:
        return flash_attention(q, k, v, causal=True,
                               window=None if window <= 0 else window)
    group = hq // hkv
    scale = d ** -0.5
    qg = q.reshape(b, sq, hkv, group, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    q_pos = torch.arange(sq, device=q.device)[:, None] + q_offset
    k_pos = torch.arange(skv, device=q.device)[None, :]
    mask = k_pos <= q_pos
    if window > 0:
        mask &= k_pos > (q_pos - window)
    mask = mask[None, None, None]
    if lengths is not None:
        mask = mask & (k_pos[None, None, None] <
                       lengths[:, None, None, None, None])
    s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(b, sq, hq, d).to(q.dtype)


def banded_local_attention(q, k, v, *, window: int):
    """Sliding-window self-attention computing only the W-band of scores.

    Queries are blocked by W; block i attends key blocks [i-1, i]
    (sufficient for window <= W), so scores are (S x 2W).  S % window
    == 0 and S >= 2 * window (callers pad).  DTensors first take the
    flash kernel's layout (``sharded.local_apply``: only batch and heads
    stay sharded) and compute on each rank's shards, so blocking the
    sequence never splits a sharded dim.
    """
    if is_dtensor(q):
        g = q.shape[2] // k.shape[2]
        heads = sharded.Role(heads=2)
        return sharded.local_apply(
            lambda *a: banded_local_attention(*a, window=window), (q, k, v),
            (heads,) + 2 * (sharded.Role(heads=2, group=g),), (heads,))[0]
    b, s, hq, d = q.shape
    _, _, hkv, _ = k.shape
    w = window
    assert s % w == 0 and s >= 2 * w
    nb = s // w
    group = hq // hkv
    scale = d ** -0.5

    qb = q.reshape(b, nb, w, hkv, group, d)
    kb = k.reshape(b, nb, w, hkv, d)
    vb = v.reshape(b, nb, w, hkv, d)
    zero = torch.zeros_like(kb[:, :1])
    k2 = torch.cat([torch.cat([zero, kb[:, :-1]], dim=1), kb],
                   dim=2)  # (b, nb, 2w, hkv, d)
    v2 = torch.cat([torch.cat([zero, vb[:, :-1]], dim=1), vb], dim=2)

    sc = torch.einsum("bnqhgd,bnkhd->bnhgqk", qb.float(),
                      k2.float()) * scale
    dev = q.device
    q_pos = torch.arange(w, device=dev)[:, None] + w
    k_pos = torch.arange(2 * w, device=dev)[None, :]
    first = torch.arange(nb, device=dev) == 0  # block 0's prev band pads
    mask = (k_pos <= q_pos) & (k_pos > q_pos - w)
    mask = mask[None, None] & ~(first[None, :, None, None]
                                & (k_pos[None, None] < w))
    sc = torch.where(mask[:, :, None, None], sc, -1e30)
    p = torch.softmax(sc, dim=-1)
    o = torch.einsum("bnhgqk,bnkhd->bnqhgd", p, v2.float())
    return o.reshape(b, s, hq, d).to(q.dtype)


def _head_dim_sharded(w, dim: int) -> bool:
    return is_dtensor(w) and any(getattr(p, "dim", None) == dim
                                 for p in w.placements)


def project_in(x, w, heads: str, rules: ShardingRules):
    """x (B, S, D) @ w (D, H, K) -> (B, S, H, K), H under the logical
    axis ``heads``.  On DTensors the product's merged dim first takes
    the split of its outer part (a split DTensor picks for it may not
    divide into heads), and a ``w`` with K sharded is merged as (K, H),
    sharded dim first (merging (H, K) would stride the shard)."""
    b, s, dm = x.shape
    if _head_dim_sharded(w, 2):
        y = constrain(x @ w.transpose(1, 2).reshape(dm, -1),
                      ("batch", None, "head_dim"), rules)
        return y.reshape(b, s, w.shape[2], w.shape[1]).transpose(2, 3)
    y = constrain(x @ w.reshape(dm, -1), ("batch", None, heads), rules)
    return y.reshape(b, s, *w.shape[1:])


def project_out(o, w):
    """o (B, S, H, K) @ w (H, K, D) -> (B, S, D), merging (K, H) where a
    DTensor ``w`` shards K, as ``project_in`` does."""
    b, s = o.shape[:2]
    if _head_dim_sharded(w, 1):
        return o.transpose(2, 3).reshape(b, s, -1) @ \
            w.transpose(0, 1).reshape(-1, w.shape[-1])
    return o.reshape(b, s, -1) @ w.reshape(-1, w.shape[-1])


def attention_block(x, wq, wk, wv, wo, *, positions, window: int,
                    rope_fraction, rules: ShardingRules, cache=None,
                    cache_pos=None, ring: bool = False,
                    static_local_window: int | None = None):
    """Full attention sublayer (projections + rope + attention + out).

    cache: None (prefill over x's own keys) or dict(k=(B,Smax,Hkv,D),
    v=...) for decode, which this call updates in place; cache_pos: the
    absolute decode position.  ``ring=True`` treats the cache as a
    circular window buffer (writes go to pos % cache_len and every
    written slot is attended).  Returns (out, the computed (k, v) for a
    prefill, or the cache dict for decode).
    """
    b, s, dm = x.shape
    q = project_in(x, wq, "q_heads", rules)
    k, v = (project_in(x, w, "kv_heads", rules) for w in (wk, wv))
    q = constrain(q, ("batch", None, "q_heads", "head_dim"), rules)
    k = constrain(k, ("batch", None, "kv_heads", "head_dim"), rules)
    v = constrain(v, ("batch", None, "kv_heads", "head_dim"), rules)
    q = rope(q, positions, fraction=rope_fraction)
    k = rope(k, positions, fraction=rope_fraction)

    if cache is None:
        slw = static_local_window
        if slw is not None and s % slw == 0 and s >= 2 * slw:
            # Heterogeneous stacks (gemma3 5:1): the per-layer window
            # picks banded (local layers) or full (globals).
            if window > 0:
                o = banded_local_attention(q, k, v, window=slw)
            else:
                o = masked_attention(q, k, v, window=-1, q_offset=0)
        else:
            o = masked_attention(q, k, v, window=window, q_offset=0)
        new_kv = (k, v)
    else:
        cache_len = cache["k"].shape[1]
        if ring:
            write_pos = cache_pos % cache_len
            q_offset = cache_len  # all written slots are in-window
            eff_window = -1
            length = min(cache_pos + s, cache_len)
        else:
            write_pos = cache_pos
            q_offset = cache_pos
            eff_window = window
            length = cache_pos + s
        # As lax.dynamic_update_slice: the start clamps into the buffer.
        write_pos = min(max(write_pos, 0), cache_len - s)
        cache["k"][:, write_pos:write_pos + s] = k.to(cache["k"].dtype)
        cache["v"][:, write_pos:write_pos + s] = v.to(cache["v"].dtype)
        axes = ("cache_batch", "cache_seq", "cache_heads", "cache_dim")
        ck = constrain(cache["k"], axes, rules)
        cv = constrain(cache["v"], axes, rules)
        lengths = torch.full((b,), length, dtype=torch.int32,
                             device=x.device)
        o = masked_attention(q, ck, cv, window=eff_window,
                             q_offset=q_offset, lengths=lengths)
        new_kv = cache
    out = project_out(o, wo)
    return out, new_kv
