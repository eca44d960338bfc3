"""The tensor-core kernels of the model stack, rehearsed on the CPU.

``csrc/flash_attention_sm90.cu`` and ``csrc/ssd_sm90.cu`` run only on
an H100; ``chip_smoke.py`` holds them to their plain versions there.
What the CPU can check is checked here:

- the dispatch rules (``kernel_for``) that send a CUDA call to the new
  kernels or to the CUDA-core ones, from the dtype and the shape alone;
- plain-torch emulations of the new kernels' arithmetic (their tile
  order, their f32 state, the bf16 rounding of the tensor-core operands
  and the hi/lo split of the f32 factors), held to the plain versions
  under the tolerances ``chip_smoke.py`` holds the kernels to, and the
  flash emulation also to the JAX package's oracle.  A bf16 P (or M)
  without the split misses those tolerances, and so does the SSD fault
  that ``chip_smoke.py`` plants; the tests show both.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref as jattention
from repro_torch.configs import ARCHS, get_config
from repro_torch.kernels.flash_attention import attention_ref
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ssd_chunks_ref

torch.set_num_threads(1)
BF = torch.bfloat16
LOG2E = 1.4426950408889634


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()


def bf16(a):
    return a.to(BF).float()


# ------------------------------------------------------------- dispatch
ATTN_ARCHS = [a for a in ARCHS if get_config(a).n_heads]


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_every_config_head_dim_takes_the_wgmma_kernel_in_bf16(arch):
    cfg = get_config(arch)
    d, hq, hkv = cfg.head_dim_, cfg.n_heads, cfg.n_kv_heads
    assert flash_ops.kernel_for(BF, d, hq, hkv) == "flash_attention_sm90"
    assert flash_ops.kernel_for(torch.float32, d, hq, hkv) \
        == "flash_attention"


@pytest.mark.parametrize("d,want", [(20, "flash_attention"),
                                    (260, "flash_attention"),
                                    (8, "flash_attention_sm90"),
                                    (256, "flash_attention_sm90")])
def test_flash_dispatch_edges(d, want):
    assert flash_ops.kernel_for(BF, d, 4, 2) == want


@pytest.mark.parametrize("p,n,chunk,dtype,want", [
    (64, 64, 128, BF, "ssd_sm90"),        # zamba2-7b
    (64, 128, 128, BF, "ssd_sm90"),       # mamba2-130m
    (16, 16, 16, BF, "ssd_sm90"),         # the smoke configs
    (64, 64, 128, torch.float32, "ssd"),
    (16, 8, 16, BF, "ssd"),               # n = 8
    (20, 64, 128, BF, "ssd"),
    (64, 64, 100, BF, "ssd"),             # a short sequence's chunk
    (64, 256, 256, BF, "ssd")])           # beyond shared memory
def test_ssd_dispatch(p, n, chunk, dtype, want):
    assert ssd_ops.kernel_for(dtype, p, n, chunk) == want


def test_model_configs_ssd_take_the_tensor_core_kernel():
    for arch in ARCHS:
        ssm = get_config(arch).ssm
        if ssm is not None:
            assert ssd_ops.kernel_for(BF, ssm.head_dim, ssm.d_state,
                                      ssm.chunk) == "ssd_sm90", arch


# ------------------------------------------------- flash, as the kernel
def flash_sm90_emulation(q, k, v, *, scale=None, causal=True, window=None,
                         split=True):
    """The arithmetic of ``flash_attention_sm90``: blocks of 128 query
    rows, kv tiles of 128 keys (64 past D = 64) from the block's first
    visible tile on, S = Q K^T of bf16 operands summed in f32, the
    online softmax in log2 units in f32, P as hi + lo bf16 (or, with
    ``split=False``, bf16 alone), l summed from the f32 p."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    scale = d ** -0.5 if scale is None else scale
    bn = 128 if d <= 64 else 64
    off = skv - sq
    qf = q.float().transpose(1, 2)                     # (b, hq, sq, d)
    kf = k.float().repeat_interleave(hq // hkv, 2).transpose(1, 2)
    vf = v.float().repeat_interleave(hq // hkv, 2).transpose(1, 2)
    out = torch.zeros(b, hq, sq, d)
    for q0 in range(0, sq, 128):
        rows = torch.arange(q0, min(q0 + 128, sq))
        kv_lo, kv_hi = 0, skv
        if causal:
            kv_hi = min(skv, int(rows[-1]) + off + 1)
        if window is not None:
            kv_lo = max(0, q0 + off - window + 1)
        m = torch.full((b, hq, len(rows)), -torch.inf)
        l = torch.zeros(b, hq, len(rows))
        acc = torch.zeros(b, hq, len(rows), d)
        for k0 in range((kv_lo // bn) * bn, kv_hi, bn):
            cols = torch.arange(k0, min(k0 + bn, skv))
            s = qf[:, :, rows] @ kf[:, :, cols].transpose(-1, -2)
            qp, kp = rows[:, None] + off, cols[None, :]
            ok = torch.ones(len(rows), len(cols), dtype=torch.bool)
            if causal:
                ok &= kp <= qp
            if window is not None:
                ok &= kp > qp - window
            s = torch.where(ok, s * (scale * LOG2E), -torch.inf)
            m_new = torch.maximum(m, s.amax(-1))
            mu = torch.where(m_new == -torch.inf, 0.0, m_new)
            alpha = torch.exp2(m - mu)
            p = torch.exp2(s - mu[..., None])
            ph = bf16(p)
            pv = ph @ vf[:, :, cols]
            if split:
                pv = pv + bf16(p - ph) @ vf[:, :, cols]
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + pv
            m = m_new
        out[:, :, rows] = acc / torch.where(l == 0, 1.0, l)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def flash_inputs(seed, b, sq, skv, hq, hkv, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
            for _ in range(2))
    return [torch.from_numpy(a).to(BF) for a in (q, k, v)]


FLASH_CASES = [  # (b, sq, skv, hq, hkv, d, causal, window)
    (1, 512, 512, 4, 4, 112, True, None),   # zamba2-7b's head dim
    (1, 384, 384, 4, 1, 120, True, 100),    # danube3's head dim, GQA 4
    (1, 320, 320, 2, 1, 256, True, 64),     # gemma3's, Hkv = 1
    (1, 200, 330, 2, 2, 64, True, None),    # Skv > Sq, ragged tiles
    (1, 256, 256, 2, 2, 64, False, None),
    (1, 12, 5, 2, 2, 16, True, None)]       # rows that see no key


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_emulation_within_the_kernels_tolerance(case):
    b, sq, skv, hq, hkv, d, causal, window = case
    q, k, v = flash_inputs(sum(case[:6]), b, sq, skv, hq, hkv, d)
    got = flash_sm90_emulation(q, k, v, causal=causal, window=window)
    want = attention_ref(q, k, v, causal=causal, window=window)
    assert CS.allowance_used(got, want, *CS.FLASH_BF16_TOL) <= 1
    jwant = jattention(*(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                         for t in (q, k, v)), causal=causal, window=window)
    jwant = torch.from_numpy(np.asarray(jwant, np.float32))
    assert CS.allowance_used(got, jwant, *CS.FLASH_BF16_TOL) <= 1
    if sq > skv and causal:
        assert not got[:, :sq - skv].float().any()


def test_flash_bf16_p_alone_misses_the_tolerance():
    """Why the kernel splits P: rounding p to bf16 before P V moves the
    output by more than one bf16 ulp."""
    q, k, v = flash_inputs(3, 1, 512, 512, 4, 4, 112)
    got = flash_sm90_emulation(q, k, v, split=False)
    want = attention_ref(q, k, v)
    assert CS.allowance_used(got, want, *CS.FLASH_BF16_TOL) > 1


# --------------------------------------------------- ssd, as the kernel
def ssd_sm90_emulation(x, dac, dt, B, C, *, chunk, split=True,
                       strict=False):
    """The arithmetic of ``ssd_sm90``: C B^T of bf16 operands in f32; M
    masked before the exponent; M and B w as hi + lo bf16 (bf16 alone
    with ``split=False``) times bf16 x, summed in f32.  ``strict``
    plants the fault that leaves the diagonal u == t out of the mask."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    nc = s // chunk
    xq = x.reshape(b, nc, chunk, h, p).float().permute(0, 1, 3, 2, 4)
    dacq = dac.reshape(b, nc, chunk, h).permute(0, 1, 3, 2)  # (b,c,h,q)
    dtq = dt.reshape(b, nc, chunk, h).permute(0, 1, 3, 2)
    Bq = B.reshape(b, nc, chunk, n).float()
    Cq = C.reshape(b, nc, chunk, n).float()
    cb = (Cq @ Bq.transpose(-1, -2))[:, :, None]  # (b, c, 1, t, u)
    causal = torch.ones(chunk, chunk, dtype=torch.bool).tril(
        -1 if strict else 0)
    diff = dacq[..., :, None] - dacq[..., None, :]
    M = cb * torch.exp(torch.where(causal, diff, -torch.inf)) \
        * dtq[..., None, :]
    w = torch.exp(dacq[..., -1:] - dacq) * dtq  # (b, c, h, q)
    Bw = (Bq[:, :, None] * w[..., None]).transpose(-1, -2)  # (b,c,h,n,q)

    def times_x(a):
        hi = bf16(a)
        out = hi @ xq
        return out + bf16(a - hi) @ xq if split else out

    y = times_x(M).permute(0, 1, 3, 2, 4).reshape(b, s, h, p)
    return y, times_x(Bw)


def ssd_inputs(seed, b, s, h, p, n, chunk, *, dt_hi=0.1, a_hi=16.0):
    """x, dac, dt, B, C as a Mamba2 layer hands them over, x, B and C in
    bf16."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    B, C = (rng.standard_normal((b, s, n)).astype(np.float32)
            for _ in range(2))
    dt = (rng.random((b, s, h)) * dt_hi + 1e-3).astype(np.float32)
    A = -(rng.random(h) * (a_hi - 1) + 1).astype(np.float32)
    dac = np.cumsum((dt * A).reshape(b, s // chunk, chunk, h), axis=2,
                    dtype=np.float32).reshape(b, s, h)
    tb = lambda a: torch.from_numpy(a).to(BF)
    return (tb(x), torch.from_numpy(dac), torch.from_numpy(dt), tb(B),
            tb(C))


def ssd_allowance(got, want):
    scale = float(max(w.abs().max() for w in want))
    return max(CS.allowance_used(a, w, CS.SSD_TOL * scale)
               for a, w in zip(got, want))


SSD_CASES = [  # (b, s, h, p, n, chunk)
    (1, 256, 3, 64, 64, 128),   # zamba2-7b's p, n, q
    (1, 256, 2, 64, 128, 128),  # mamba2-130m's state
    (2, 64, 2, 32, 16, 32)]


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_emulation_within_the_kernels_tolerance(case):
    b, s, h, p, n, chunk = case
    args = ssd_inputs(sum(case), *case)
    got = ssd_sm90_emulation(*args, chunk=chunk)
    want = ssd_chunks_ref(*args, chunk=chunk)
    assert all(g.shape == w.shape for g, w in zip(got, want))
    assert ssd_allowance(got, want) <= 1


def test_ssd_emulation_with_overflowing_decay_stays_finite():
    """dt = 50 with A = -10: exp(dac_t - dac_u) for u > t overflows, so
    the mask must apply before the exponent, in the kernel as in the
    plain version."""
    args = ssd_inputs(4, 1, 64, 2, 32, 16, 32, dt_hi=0.0, a_hi=1.0)
    x, dac, dt, B, C = args
    dt = torch.full_like(dt, 50.0)
    dac = torch.cumsum((dt * -10.0).reshape(1, 2, 32, 2), 2).reshape(
        1, 64, 2)
    got = ssd_sm90_emulation(x, dac, dt, B, C, chunk=32)
    want = ssd_chunks_ref(x, dac, dt, B, C, chunk=32)
    assert all(torch.isfinite(g).all() for g in got)
    assert ssd_allowance(got, want) <= 1


@pytest.mark.parametrize("variant", ["bf16 factors alone",
                                     "diagonal left out of the mask"])
def test_ssd_tolerance_rejects(variant):
    """Why the kernel splits M and B w, and that ``SSD_TOL`` rejects the
    fault ``chip_smoke.py`` plants in the kernel."""
    case = SSD_CASES[0]
    args = ssd_inputs(sum(case), *case)
    got = ssd_sm90_emulation(*args, chunk=case[-1],
                             split=variant != "bf16 factors alone",
                             strict=variant != "bf16 factors alone")
    assert ssd_allowance(got, ssd_chunks_ref(*args, chunk=case[-1])) > 1
