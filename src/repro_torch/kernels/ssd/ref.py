"""Plain PyTorch version of the SSD intra-chunk kernel: the per-cell
math of ``repro.kernels.ssd.ref._chunk_intra``, vectorized over batch,
chunks and heads, in f32 (in f64 for f64 inputs, so that gradient
checks can run in double precision)."""

from __future__ import annotations

import torch


def ssd_chunks_ref(x, dac, dt, B, C, *, chunk: int):
    """x: (b, s, h, p); dac, dt: (b, s, h) f32 (dac the within-chunk
    inclusive cumsum of dt * A); B, C: (b, s, n); s % chunk == 0.

    Returns (y_intra (b, s, h, p) f32, states (b, s // chunk, h, n, p)
    f32): per (batch, head, chunk) cell,
    ``y_intra[t] = sum_{u<=t} (C_t . B_u) exp(dac_t - dac_u) dt_u x_u``
    and ``state = sum_u B_u^T exp(dac_last - dac_u) dt_u x_u``."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    nc = s // chunk
    f = torch.promote_types(x.dtype, torch.float32)
    xq = x.reshape(b, nc, chunk, h, p).to(f)
    dacq = dac.reshape(b, nc, chunk, h).to(f)
    dtq = dt.reshape(b, nc, chunk, h).to(f)
    Bq = B.reshape(b, nc, chunk, n).to(f)
    Cq = C.reshape(b, nc, chunk, n).to(f)
    CB = torch.einsum("bctn,bcun->bctu", Cq, Bq)
    causal = torch.ones(chunk, chunk, dtype=torch.bool,
                        device=x.device).tril()[None, None, :, :, None]
    # Mask the exponent, not its result: exp(dac_t - dac_u) for u > t
    # can overflow, and inf * 0 is NaN.
    diff = dacq[:, :, :, None, :] - dacq[:, :, None, :, :]  # (b,c,t,u,h)
    L = torch.exp(torch.where(causal, diff, -torch.inf))
    M = CB[..., None] * L * dtq[:, :, None, :, :]
    y = torch.einsum("bctuh,bcuhp->bcthp", M, xq)
    decay_to_end = torch.exp(dacq[:, :, -1:, :] - dacq)  # (b,c,q,h)
    Bw = Bq[:, :, :, None, :] * (decay_to_end * dtq)[..., None]
    states = torch.einsum("bcuhn,bcuhp->bchnp", Bw, xq)
    return y.reshape(b, s, h, p), states
