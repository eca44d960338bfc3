"""Mamba2 (SSD) block: in-proj, causal depthwise conv, SSD scan, gated
out-proj.  The prefill's scan goes through ``kernels/ssd`` (the CUDA
intra-chunk kernel on a card, its plain version on the CPU); decode is
the single-step recurrence in torch.

Decode keeps a recurrent state (h: (B, NH, N, P) f32, conv tail:
(B, W-1, Di)), constant memory per token.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.ssd.ops import ssd_chunked_scan
from .layers import rmsnorm
from .sharding import ShardingRules, constrain


def _causal_conv(x, conv_w, tail=None):
    """Depthwise causal conv. x: (B, S, Di); conv_w: (W, Di);
    tail: (B, W-1, Di) previous context for decode."""
    w = conv_w.shape[0]
    s = x.shape[1]
    if tail is None:
        pad = torch.zeros((x.shape[0], w - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = tail.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # (B, S+W-1, Di)
    out = torch.zeros_like(x)
    for i in range(w):  # small static W (4): unrolled taps
        out = out + xp[:, i:i + s] * conv_w[i][None, None, :]
    return out, xp[:, s:]  # the last W-1 positions


def mamba2_block(x, p, cfg, rules: ShardingRules, state=None,
                 return_state: bool = False):
    """x: (B, S, D). p: the layer's params. state: None (train, or
    prefill when ``return_state=True``) or dict(h, conv) for single-step
    decode.  Returns (y, new_state)."""
    b, s, d = x.shape
    di = cfg.ssm.expand * d
    n = cfg.ssm.d_state
    pdim = cfg.ssm.head_dim
    nh = di // pdim

    zx = x @ p["w_in"]  # (B,S,2*Di)
    z, xin = zx[..., :di], zx[..., di:]
    bc = x @ p["w_bc"]  # (B,S,2N)
    Bm, Cm = bc[..., :n], bc[..., n:]
    dt = F.softplus((x @ p["w_dt"]).float()
                    + p["dt_bias"].float())  # (B,S,NH)
    A = -torch.exp(p["a_log"].float())  # (NH,)

    xin, new_tail = _causal_conv(xin, p["conv_w"],
                                 None if state is None else state["conv"])
    xin = F.silu(xin.float()).to(x.dtype)
    xh = xin.reshape(b, s, nh, pdim)
    xh = constrain(xh, ("batch", None, "ssm_heads", None), rules)

    if state is None:
        chunk = min(cfg.ssm.chunk, s)
        pad = -s % chunk
        xs, dts, Bs, Cs = xh, dt, Bm, Cm
        if pad:
            # Padding with dt=0 => exp(0)=1 decay and zero input: the
            # final state equals the state at position s.
            xs = F.pad(xh, (0, 0, 0, 0, 0, pad))
            dts = F.pad(dt, (0, 0, 0, pad))
            Bs = F.pad(Bm, (0, 0, 0, pad))
            Cs = F.pad(Cm, (0, 0, 0, pad))
        res = ssd_chunked_scan(xs, dts, A, Bs, Cs, chunk=chunk,
                               return_final=return_state)
        y = (res[0] if return_state else res)[:, :s]
        new_h = res[1] if return_state else None
    else:
        # Single-step recurrence: h <- exp(dt*A) h + dt * B x^T; y = C h.
        assert s == 1
        h = state["h"].float()  # (B, NH, N, P)
        da = torch.exp(dt[:, 0, :, None, None] * A[None, :, None, None])
        upd = (dt[:, 0, :, None, None]
               * Bm[:, 0, None, :, None].float()
               * xh[:, 0, :, None, :].float())
        h = h * da + upd
        y = torch.einsum("bn,bhnp->bhp", Cm[:, 0].float(),
                         h)[:, None].reshape(b, 1, nh, pdim)
        new_h = h
    y = y.to(x.dtype) + xh * p["d_skip"][None, None, :, None]
    y = y.reshape(b, s, di)
    y = rmsnorm(y * F.silu(z.float()).to(x.dtype), p["out_norm"])
    out = y @ p["w_out"]
    if state is not None or return_state:
        new_state = {"h": new_h, "conv": new_tail}
    else:
        new_state = None
    return out, new_state
