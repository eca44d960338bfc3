"""Shared neural layers: RMSNorm, rotary embeddings, SwiGLU MLP, the
cross-entropy loss.

Norms and activations compute in f32 and cast back to the input's type,
as ``repro.models.layers`` does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.sharded import is_dtensor


def rmsnorm(x, w, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


def rope(x, positions, *, base: float = 10000.0, fraction: float = 1.0):
    """Rotary embedding on the leading ``fraction`` of head dims.

    x: (B, S, H, D); positions: (B, S) int.  chatglm3 uses fraction=0.5
    (2-d RoPE on half the dims); others use 1.0.
    """
    d = x.shape[-1]
    d_rot = int(d * fraction)
    d_rot -= d_rot % 2
    if d_rot == 0:
        return x
    xr, xp = x[..., :d_rot], x[..., d_rot:]
    half = d_rot // 2
    freqs = base ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[:, :, None].float() * freqs[None, None, :]
    cos = torch.cos(ang)[:, :, None, :]  # (B,S,1,half)
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = xr[..., :half].float(), xr[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out.to(x.dtype), xp], dim=-1)


def swiglu(x, w_gate, w_up, w_down):
    g = x @ w_gate
    u = x @ w_up
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ w_down


def cross_entropy_loss(logits, labels, *, z_loss: float = 0.0):
    """Mean CE over tokens; logits (..., V) in any type, f32 math.  The
    label's logit is gathered; DTensor logits select it with the
    reference's iota-compare, which stays sharded over vocab (a gather
    on a sharded dim would all-gather the logits first)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    if is_dtensor(logits):
        iota = torch.arange(logits.shape[-1], device=logits.device)
        ll = torch.where(iota == labels.long()[..., None], logits,
                         0.0).sum(dim=-1)
    else:
        ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    loss = (lse - ll).mean()
    if z_loss:
        loss = loss + z_loss * (lse ** 2).mean()
    return loss
