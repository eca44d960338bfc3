"""The port's ``Transformer`` against ``repro.models.Transformer`` with
the same (carried) parameters, on the CPU, in f32.

For the smoke configs of zamba2-7b (hybrid, the slice's model),
mamba2-130m (SSM), gemma3-1b (local:global; at 32 tokens its local
layers take the banded path), chatglm3-6b (``rope_fraction`` 0.5),
mixtral-8x7b and kimi-k2 (MoE; kimi-k2 with its shared expert), plus a
six-layer gemma3 whose last layer is global: ``prefill``'s
logits and every cache entry, then three ``decode_step``s continuing
from that cache, equal the JAX package's within atol/rtol 1e-4 (the
sums run in other orders; logits are O(1)).  On the CPU the prefill's
SSD scans and attention take the kernels' plain versions, through the
same wrappers that launch the kernels on a card.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, smoke
from repro.models import Transformer as JTransformer
from repro.models import tree_init
from repro_torch.carry import load_jax_params
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import smoke as tsmoke
from repro_torch.models import Transformer

torch.set_num_threads(1)

B = 2
CASES = [  # (arch, prompt length, layers or None for the smoke depth)
    ("zamba2-7b", 32, None),
    ("zamba2-7b", 20, None),  # 20 pads to two SSD chunks of 16
    ("mamba2-130m", 20, None),
    ("gemma3-1b", 32, None),  # banded local layers
    ("gemma3-1b", 20, None),  # masked local layers (20 % 16 != 0)
    ("gemma3-1b", 32, 6),  # five local layers, then a global one
    ("chatglm3-6b", 20, None),
    ("musicgen-large", 12, None),  # dense behind a stub frontend
    ("mixtral-8x7b", 32, None),  # MoE top-2 behind windowed attention
    ("mixtral-8x7b", 20, None),
    ("kimi-k2-1t-a32b", 20, None),  # MoE with a shared expert
]


def build(arch, n_layers):
    cfg, tcfg = smoke(get_config(arch)), tsmoke(tget_config(arch))
    if n_layers:
        cfg = replace(cfg, n_layers=n_layers)
        tcfg = replace(tcfg, n_layers=n_layers)
    jm = JTransformer(cfg)
    params = tree_init(jm.param_specs(), jax.random.key(0), jnp.float32)
    model = Transformer(tcfg, device="cpu", seed=1)
    load_jax_params(model, jax.tree.map(np.asarray, params))
    return cfg, jm, params, model


def inputs(cfg, rng, s):
    if cfg.stub_frontend is not None:
        return rng.standard_normal((B, s, cfg.d_model)).astype(np.float32)
    return rng.integers(0, cfg.vocab, (B, s)).astype(np.int32)


def kw(cfg, a, port: bool):
    key = "embeds" if cfg.stub_frontend is not None else "tokens"
    return {key: torch.from_numpy(a) if port else jnp.asarray(a)}


def close(got, want, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4, err_msg=what)


def pad_kv(cache: dict, extra: int) -> dict:
    """A prefill cache as numpy, its KV sequence axis grown by ``extra``
    zero slots so decode can continue from it."""
    out = {}
    for k, v in cache.items():
        v = np.asarray(v)
        if k in ("k", "v", "ak", "av"):
            v = np.pad(v, [(0, 0), (0, 0), (0, extra)] +
                       [(0, 0)] * (v.ndim - 3))
        out[k] = v
    return out


@pytest.mark.parametrize("arch,s,n_layers", CASES)
def test_prefill_and_decode_match_jax(arch, s, n_layers):
    cfg, jm, params, model = build(arch, n_layers)
    rng = np.random.default_rng(s)
    a = inputs(cfg, rng, s)
    jl, jc = jax.jit(jm.prefill)(params, **kw(cfg, a, False))
    tl, tc = model.prefill(**kw(cfg, a, True))
    assert tl.shape == (B, 1, cfg.vocab)
    close(tl, jl, "prefill logits")
    assert set(tc) == set(jc)
    for k in jc:
        assert tuple(tc[k].shape) == jc[k].shape, k
        close(tc[k], jc[k], f"prefill cache {k}")

    steps = 3
    start = {k: v for k, v in pad_kv(jc, steps).items()}
    jcache = {k: jnp.asarray(v) for k, v in start.items()}
    tcache = {k: torch.from_numpy(v.copy()) for k, v in start.items()}
    step = jax.jit(lambda p, x, c, pos: jm.decode_step(p, x, c, pos))
    for i in range(steps):
        x = inputs(cfg, rng, 1)
        jl, jcache = step(params, jnp.asarray(x), jcache, s + i)
        tl, tcache = model.decode_step(torch.from_numpy(x), tcache, s + i)
        close(tl, jl, f"decode {i} logits")
        for k in jcache:
            close(tcache[k], jcache[k], f"decode {i} cache {k}")


@pytest.mark.parametrize("arch", ["zamba2-7b", "mamba2-130m"])
def test_prefill_equals_teacher_forced_decode(arch):
    """The check the chip run makes at full width: a prefill's last
    logits and final states equal a decode loop over the same tokens
    (which reaches no kernel)."""
    cfg = tsmoke(tget_config(arch))
    model = Transformer(cfg, device="cpu", seed=0)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (B, 24)))
    logits, cache = model.prefill(toks)
    dcache = model.init_cache(B, 24)
    for t in range(24):
        dl, dcache = model.decode_step(toks[:, t:t + 1], dcache, t)
    torch.testing.assert_close(logits, dl, atol=1e-4, rtol=1e-4)
    for k in cache:
        torch.testing.assert_close(cache[k], dcache[k], atol=1e-4,
                                   rtol=1e-4)


def test_forward_matches_jax():
    cfg, jm, params, model = build("zamba2-7b", None)
    a = inputs(cfg, np.random.default_rng(9), 40)
    want = jax.jit(jm.forward_train)(params, **kw(cfg, a, False))
    close(model.forward_train(**kw(cfg, a, True)), want, "forward logits")


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "kimi-k2-1t-a32b"])
def test_moe_forward_matches_jax(arch):
    cfg, jm, params, model = build(arch, None)
    a = inputs(cfg, np.random.default_rng(9), 40)
    want = jax.jit(jm.forward_train)(params, **kw(cfg, a, False))
    close(model.forward_train(**kw(cfg, a, True)), want, "forward logits")
