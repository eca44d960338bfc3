"""Mixture-of-Experts layer with sort-based capacity dispatch.

No (tokens x experts x capacity) one-hots: token->expert assignments are
argsorted by expert id, ranked within expert by a cumulative count, dropped
beyond capacity, and scattered into an (E, C, D) buffer — static shapes,
scalable to kimi-k2's 384 experts where dense dispatch is impossible.
Top-k gate weights are softmax-renormalized over the selected experts
(Mixtral §2).  An optional shared expert (Kimi/DeepSeek style) adds a dense
SwiGLU path.

A port of ``repro.models.moe`` step by step, the (E, C, D) buffers
pinned to the mesh with ``constrain`` as there (the identity without a
mesh).  No kernel is reached: dispatch and combine
are a stable sort plus two scatters, the expert products batched
matmuls, as the JAX package computes them outside any Pallas kernel.
Nothing here waits on the card: no shape depends on the routing, so a
dropped pair is zeroed (as the JAX package's ``mode="drop"`` /
``mode="fill"`` do) instead of filtered out.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import swiglu
from .sharding import ShardingRules, constrain

BUF_AXES = ("experts", "expert_in", "expert_d")


def capacity(t: int, top_k: int, n_experts: int,
             capacity_factor: float) -> int:
    """Slots an expert holds for ``t`` tokens: the JAX package's
    expression verbatim (the unary minus binds before ``//``, so this is
    ceil(t * k / e) * cf), at least 8, rounded up to a multiple of 8."""
    t, e = int(t), int(n_experts)
    cap = int(max(8, -(-(t * top_k) // e * capacity_factor)))
    return -(-cap // 8) * 8  # round up to 8


def route(xf, router_w, top_k: int):
    """(f32 router logits (t, E), top-k gates (t, k), top-k experts
    (t, k)) of flattened tokens.  ``jax.lax.top_k`` puts the lower index
    first on ties and ``torch.topk`` does not promise that; with f32
    logits of real-valued inputs ties have measure zero, so the two
    agree."""
    logits = xf.float() @ router_w.float()
    top_vals, top_idx = torch.topk(logits, top_k, dim=-1)
    gates = torch.softmax(top_vals, dim=-1)  # renormalize over selected
    return logits, gates, top_idx


def expert_counts(flat_e, n_experts: int):
    """Pairs routed to each expert (``bincount`` would wait on the card
    for the largest index)."""
    return flat_e.new_zeros(n_experts).scatter_add(
        0, flat_e, torch.ones_like(flat_e))


def dispatch_order(top_idx, n_experts: int):
    """(order, expert, rank) of the flattened (token, choice) pairs,
    sorted by expert: ``order`` indexes the flat pairs, ``rank`` is each
    pair's position within its expert.  The sort must be stable (as
    ``jnp.argsort`` is): it decides which tokens a full expert drops."""
    flat_e = top_idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    counts = expert_counts(flat_e, n_experts)
    offsets = torch.cumsum(counts, 0) - counts
    rank = torch.arange(flat_e.numel(), device=flat_e.device) \
        - offsets[e_sorted]
    return order, e_sorted, rank


def dispatch(xf, e_sorted, tok_sorted, rank, cap: int, n_experts: int,
             rules: ShardingRules | None = None):
    """Scatter-add each pair's token into the (E, cap, D) buffer at
    (expert, rank).  A pair of rank >= cap is dropped: it adds zeros to
    slot 0.  Returns (buffer, kept (t*k, 1), slot)."""
    keep = (rank < cap)[:, None]
    slot = torch.where(keep[:, 0], rank, 0)
    buf = xf.new_zeros((n_experts, cap, xf.shape[-1]))
    if rules is not None:
        buf = constrain(buf, BUF_AXES, rules)
    buf = buf.index_put((e_sorted, slot),
                        torch.where(keep, xf[tok_sorted], 0),
                        accumulate=True)
    if rules is not None:
        buf = constrain(buf, BUF_AXES, rules)
    return buf, keep, slot


def experts(buf, w_gate, w_up, w_down):
    """Expert-batched SwiGLU (batched matmuls over the expert dim)."""
    g = torch.bmm(buf, w_gate)
    u = torch.bmm(buf, w_up)
    hh = F.silu(g.float()).to(buf.dtype) * u
    return torch.bmm(hh, w_down)


def combine(out_buf, e_sorted, slot, keep, tok_sorted, g_sorted, t: int):
    """Gather each kept pair's expert output (a dropped pair's is 0),
    weight it by its gate, scatter-add it back to its token: (t, D)."""
    pair_out = torch.where(keep, out_buf[e_sorted, slot], 0) \
        * g_sorted[:, None].to(out_buf.dtype)
    y = out_buf.new_zeros((t, out_buf.shape[-1]))
    return y.index_put((tok_sorted,), pair_out, accumulate=True)


def moe_ffn(x, router_w, w_gate, w_up, w_down, *, top_k: int,
            capacity_factor: float, rules: ShardingRules | None = None,
            shared=None):
    """x: (B, S, D); router_w: (D, E); w_*: (E, D, F) / (E, F, D).

    Returns (B, S, D)."""
    b, s, d = x.shape
    e = router_w.shape[-1]
    t = b * s
    xf = x.reshape(t, d)

    _, gates, top_idx = route(xf, router_w, top_k)
    order, e_sorted, rank = dispatch_order(top_idx, e)
    tok_sorted = order // top_k  # flat pair i is token i // k
    g_sorted = gates.reshape(-1)[order]
    cap = capacity(t, top_k, e, capacity_factor)
    buf, keep, slot = dispatch(xf, e_sorted, tok_sorted, rank, cap, e,
                               rules)
    out_buf = experts(buf, w_gate, w_up, w_down)
    if rules is not None:
        out_buf = constrain(out_buf, BUF_AXES, rules)
    y = combine(out_buf, e_sorted, slot, keep, tok_sorted, g_sorted, t)
    if shared is not None:
        y = y + swiglu(xf, shared["w_gate"], shared["w_up"],
                       shared["w_down"])
    return y.reshape(b, s, d)


def moe_aux_loss(x, router_w, *, top_k: int):
    """Load-balancing auxiliary loss (Switch-style f*P)."""
    t = x.shape[0] * x.shape[1]
    e = router_w.shape[-1]
    logits, _, top_idx = route(x.reshape(t, -1), router_w, top_k)
    probs = torch.softmax(logits, dim=-1)
    f = expert_counts(top_idx.reshape(-1), e).float() / (t * top_k)
    p = probs.mean(dim=0)
    return e * torch.sum(f * p)
