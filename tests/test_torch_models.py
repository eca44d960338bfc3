"""The model stack's kernels and building blocks against the JAX package.

Inputs are made with numpy from a seed and handed to both packages.
The plain versions of the two model kernels are held to the Pallas
kernels run as the JAX package's own tests run them on the CPU
(``interpret=True``) and to its jnp oracles:

- ``ssd_chunks_ref`` against ``ssd_chunks_pallas``, and the port's
  ``ssd_chunked_scan`` against ``ssd_chunked_scan(use_kernel=True)`` and
  ``ssd_chunked_ref``, at atol/rtol 1e-4 in f32 (the sums run in other
  orders; the values are O(1));
- ``attention_ref`` (what ``flash_attention`` runs on a CPU tensor)
  against ``flash_attention(interpret=True)``, at atol 2e-5 in f32 and
  at the JAX test's 2e-2 / 1e-2 in bf16.

The CUDA kernels themselves are held to these plain versions on the
card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, get_config
from repro.kernels.flash_attention.ops import flash_attention as jflash
from repro.kernels.ssd.kernel import ssd_chunks_pallas
from repro.kernels.ssd.ops import ssd_chunked_scan as jscan
from repro.kernels.ssd.ref import ssd_chunked_ref, ssd_ref
from repro.models import Transformer as JTransformer
from repro.models import count_params as jcount
from repro.models.layers import rmsnorm as jrmsnorm
from repro.models.layers import rope as jrope
from repro.models.layers import swiglu as jswiglu
from repro_torch.configs import get_config as tget_config
from repro_torch.kernels.flash_attention import (attention_ref,
                                                 flash_attention)
from repro_torch.kernels.ssd import (ssd_chunked_scan, ssd_chunks,
                                     ssd_chunks_ref)
from repro_torch.models import Transformer, count_params, init_params
from repro_torch.models import param_specs
from repro_torch.models.layers import rmsnorm, rope, swiglu
from repro_torch.models.params import ParamSpec

torch.set_num_threads(1)

SSD_SHAPES = [  # tests/test_kernels.py's scan and kernel shapes
    (1, 64, 2, 16, 8, 16), (2, 128, 4, 32, 16, 32), (1, 256, 2, 64, 32, 64),
    (2, 128, 2, 32, 16, 32), (1, 256, 2, 64, 64, 128),  # zamba2's p, n, q
]
FLASH_SHAPES = [  # tests/test_kernels.py's six, then head dim 112
    (1, 128, 128, 4, 4, 64, True, None),
    (2, 256, 256, 8, 2, 64, True, None),
    (1, 128, 128, 4, 1, 128, True, 64),
    (2, 100, 100, 4, 2, 64, True, None),
    (1, 64, 320, 4, 2, 64, True, None),
    (1, 128, 128, 4, 4, 64, False, None),
    (2, 96, 96, 4, 4, 112, True, None),
    (1, 130, 130, 4, 2, 112, True, 48),
]


def ssd_inputs(seed, b, s, h, p, n):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = (rng.random((b, s, h)) * 0.1 + 0.01).astype(np.float32)
    A = (-rng.random(h) - 0.1).astype(np.float32)
    B = rng.standard_normal((b, s, n)).astype(np.float32)
    C = rng.standard_normal((b, s, n)).astype(np.float32)
    return x, dt, A, B, C


def dac_of(dt, A, chunk):
    b, s, h = dt.shape
    da = (dt * A[None, None, :]).reshape(b, s // chunk, chunk, h)
    return np.cumsum(da, axis=2, dtype=np.float32).reshape(b, s, h)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def close(got, want, atol=1e-4, rtol=1e-4):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


# ------------------------------------------------------------------ ssd
@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_SHAPES)
def test_ssd_plain_cells_match_pallas_kernel(b, s, h, p, n, chunk):
    x, dt, A, B, C = ssd_inputs(s + h + n, b, s, h, p, n)
    dac = dac_of(dt, A, chunk)
    nc = s // chunk
    # The TPU kernel's packing: (b*h, nc, q, .), B and C over heads.
    xq = x.reshape(b, nc, chunk, h, p).transpose(0, 3, 1, 2, 4).reshape(
        b * h, nc, chunk, p)
    pack1 = lambda a: a.reshape(b, nc, chunk, h).transpose(0, 3, 1, 2) \
        .reshape(b * h, nc, chunk, 1)
    packn = lambda a: np.broadcast_to(
        a.reshape(b, 1, nc, chunk, n), (b, h, nc, chunk, n)).reshape(
        b * h, nc, chunk, n)
    jy, jst = ssd_chunks_pallas(*(jnp.asarray(a) for a in (
        xq, pack1(dac), pack1(dt), packn(B), packn(C))), interpret=True)
    jy = np.asarray(jy).reshape(b, h, nc, chunk, p).transpose(
        0, 2, 3, 1, 4).reshape(b, s, h, p)
    jst = np.asarray(jst).reshape(b, h, nc, n, p).transpose(0, 2, 1, 3, 4)
    y, st = ssd_chunks_ref(t(x), t(dac), t(dt), t(B), t(C), chunk=chunk)
    assert y.dtype == st.dtype == torch.float32
    close(y, jy)
    close(st, jst)
    # The wrapper takes the plain version for CPU tensors.
    y2, st2 = ssd_chunks(t(x), t(dac), t(dt), t(B), t(C), chunk=chunk)
    assert torch.equal(y, y2) and torch.equal(st, st2)


@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_SHAPES)
def test_ssd_chunked_scan_matches_jax(b, s, h, p, n, chunk):
    x, dt, A, B, C = ssd_inputs(7 + s, b, s, h, p, n)
    y, hf = ssd_chunked_scan(t(x), t(dt), t(A), t(B), t(C), chunk=chunk,
                             return_final=True)
    args = [jnp.asarray(a) for a in (x, dt, A, B, C)]
    ky = jscan(*args, chunk=chunk, use_kernel=True, interpret=True)
    ry, rh = ssd_chunked_ref(*args, chunk=chunk, return_final=True)
    close(y, ky)
    close(y, ry)
    close(hf, rh)


def test_ssd_scan_of_a_padded_sequence():
    """mamba2_block pads a sequence to whole chunks with dt = 0 and zero
    inputs: the outputs up to the true length and the final state are
    those of the unpadded sequence."""
    b, s, h, p, n, chunk = 2, 50, 2, 16, 8, 16
    x, dt, A, B, C = ssd_inputs(5, b, s, h, p, n)
    pad = -s % chunk
    padded = [np.pad(a, [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2))
              for a in (x, dt, B, C)]
    xp, dtp, Bp, Cp = padded
    y, hf = ssd_chunked_scan(t(xp), t(dtp), t(A), t(Bp), t(Cp),
                             chunk=chunk, return_final=True)
    ry, rh = ssd_chunked_ref(*(jnp.asarray(a) for a in (xp, dtp, A, Bp,
                                                          Cp)),
                             chunk=chunk, return_final=True)
    close(y, ry)
    close(hf, rh)
    want = ssd_ref(*(jnp.asarray(a) for a in (x, dt, A, B, C)))
    close(y[:, :s], want, atol=1e-3, rtol=1e-3)  # the quadratic oracle
    # The state after s steps of the recurrence itself.
    state = np.zeros((b, h, n, p), np.float64)
    for i in range(s):
        state = state * np.exp(dt[:, i] * A)[:, :, None, None] + \
            dt[:, i, :, None, None] * B[:, i, None, :, None] * \
            x[:, i, :, None, :]
    close(hf, state)


def test_ssd_plain_cells_never_make_nan_from_masked_decay():
    """A large decay makes exp(dac_t - dac_u) overflow for u > t; the
    mask applies before the exponent, so no inf * 0 appears."""
    b, s, h, p, n, chunk = 1, 32, 2, 8, 4, 32
    x, dt, A, B, C = ssd_inputs(3, b, s, h, p, n)
    dt[:] = 50.0
    A[:] = -10.0
    y, st = ssd_chunks_ref(t(x), t(dac_of(dt, A, chunk)), t(dt), t(B), t(C),
                           chunk=chunk)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()


# ------------------------------------------------------- flash attention
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,causal,window", FLASH_SHAPES)
def test_flash_plain_matches_pallas_kernel(b, sq, skv, hq, hkv, d, causal,
                                           window, dtype):
    rng = np.random.default_rng(sq + skv + hq + d)
    q, k, v = (rng.standard_normal((b, s, hh, d)).astype(np.float32)
               for s, hh in ((sq, hq), (skv, hkv), (skv, hkv)))
    jd = getattr(jnp, dtype)
    want = jflash(jnp.asarray(q, jd), jnp.asarray(k, jd),
                  jnp.asarray(v, jd), causal=causal, window=window,
                  block_q=64, block_k=64, interpret=True)
    td = getattr(torch, dtype)
    tq, tk, tv = (t(a).to(td) for a in (q, k, v))
    got = attention_ref(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == td and got.shape == (b, sq, hq, d)
    if dtype == "float32":
        close(got.float(), np.asarray(want, np.float32), atol=2e-5,
              rtol=1e-5)
    else:
        close(got.float(), np.asarray(want, np.float32), atol=2e-2,
              rtol=1e-2)
    wrapped = flash_attention(tq, tk, tv, causal=causal, window=window)
    assert torch.equal(wrapped, got)


def test_flash_plain_row_with_no_valid_key_is_zero():
    """More queries than keys: the first rows of a causal suffix-aligned
    attention see no key, and give 0 (the l == 0 guard)."""
    rng = np.random.default_rng(0)
    q = t(rng.standard_normal((1, 8, 2, 16)).astype(np.float32))
    k = t(rng.standard_normal((1, 5, 2, 16)).astype(np.float32))
    got = attention_ref(q, k, k, causal=True)
    assert torch.equal(got[:, :3], torch.zeros_like(got[:, :3]))
    want = jflash(*(jnp.asarray(a.numpy()) for a in (q, k, k)),
                  causal=True, block_q=8, block_k=8, interpret=True)
    close(got, want, atol=2e-5, rtol=1e-5)


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("case,passes", [
    ("keys summed in another order", True),
    ("softmax scale of D = 128", False),
    ("last 64 keys dropped", False)])
def test_chip_smoke_flash_bf16_tolerance(case, passes):
    """The elementwise bf16 tolerance that ``chip_smoke.py`` holds the
    flash kernel to at zamba2's head dim: it lets through what rounding
    to bf16 after f32 sums in another order gives, and rejects a wrong
    softmax scale or a dropped key tile."""
    cs = _chip_smoke()
    rng = np.random.default_rng(3)
    q, k, v = (t(rng.standard_normal((1, 512, 4, 112)).astype(np.float32))
               for _ in range(3))
    want = attention_ref(q, k, v, causal=False).to(torch.bfloat16)
    if case == "keys summed in another order":
        perm = torch.as_tensor(rng.permutation(512))
        got = attention_ref(q, k[:, perm], v[:, perm], causal=False)
    elif case == "softmax scale of D = 128":
        got = attention_ref(q, k, v, causal=False, scale=128 ** -0.5)
    else:
        got = attention_ref(q, k[:, :-64], v[:, :-64], causal=False)
    used = cs.allowance_used(got.to(torch.bfloat16), want,
                             *cs.FLASH_BF16_TOL)
    assert (used <= 1) == passes, used


# --------------------------------------------------------------- layers
def test_layers_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 4, 16)).astype(np.float32)
    pos = np.tile(np.arange(6, dtype=np.int32) + 3, (2, 1))
    for frac in (1.0, 0.5):
        close(rope(t(x), t(pos), fraction=frac),
              jrope(jnp.asarray(x), jnp.asarray(pos), fraction=frac),
              atol=1e-6, rtol=1e-6)
    h = rng.standard_normal((2, 6, 32)).astype(np.float32)
    w = rng.standard_normal(32).astype(np.float32)
    close(rmsnorm(t(h), t(w), 1e-5),
          jrmsnorm(jnp.asarray(h), jnp.asarray(w), 1e-5), atol=1e-6,
          rtol=1e-6)
    wg, wu = (rng.standard_normal((32, 48)).astype(np.float32) * 0.1
              for _ in range(2))
    wd = rng.standard_normal((48, 32)).astype(np.float32) * 0.1
    close(swiglu(t(h), t(wg), t(wu), t(wd)),
          jswiglu(*(jnp.asarray(a) for a in (h, wg, wu, wd))), atol=1e-5,
          rtol=1e-5)


# --------------------------------------------------------------- params
@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_param_counts_equal_jax(arch):
    """The full configs' spec trees (nothing allocated) hold as many
    parameters as the JAX package's, the MoE ones' experts included."""
    jspecs = JTransformer(get_config(arch)).param_specs()
    specs = param_specs(tget_config(arch))
    assert count_params(specs) == jcount(jspecs)
    if arch == "zamba2-7b":
        assert count_params(specs) > 6.5e9  # full width and depth
    if arch == "mixtral-8x7b":  # 46.70 B: more than one 80 GB card in bf16
        assert 46.6e9 < count_params(specs) < 46.8e9
    if arch == "kimi-k2-1t-a32b":
        assert count_params(specs) > 1.0e12


def test_init_rules():
    specs = {"n": ParamSpec((256, 64), ("a", "b")),
             "one": ParamSpec((8,), ("a",), "ones"),
             "zero": ParamSpec((8,), ("a",), "zeros"),
             "a_log": ParamSpec((4096,), ("a",), "a_log"),
             "dt": ParamSpec((4096,), ("a",), "dt_bias")}
    gen = torch.Generator().manual_seed(0)
    p = init_params(specs, gen, torch.float32, "cpu")
    assert abs(float(p["n"].std()) - 0.02) < 0.002
    assert torch.equal(p["one"], torch.ones(8))
    assert torch.equal(p["zero"], torch.zeros(8))
    a = torch.exp(p["a_log"])
    assert float(a.min()) >= 1.0 and float(a.max()) <= 16.0
    dt = torch.nn.functional.softplus(p["dt"])
    assert float(dt.min()) >= 1e-3 - 1e-6 and float(dt.max()) <= 1e-1 + 1e-6


def test_seeded_weights_reset_and_load():
    from repro_torch.configs import smoke
    cfg = smoke(tget_config("zamba2-7b"))
    a = Transformer(cfg, device="cpu", seed=3)
    b = Transformer(cfg, device="cpu", seed=4)
    pa = [p.clone() for p in a.parameters()]
    assert any(not torch.equal(x, y) for x, y in zip(pa, b.parameters()))
    c = Transformer(cfg, device="cpu", seed=3)
    assert all(torch.equal(x, y) for x, y in zip(pa, c.parameters()))
    with pytest.raises(ValueError, match="shape"):
        a.load_params({"lm_head": np.zeros((3, 3), np.float32)})
