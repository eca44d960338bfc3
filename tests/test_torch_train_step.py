"""The port's training step against ``repro.launch.steps`` on the CPU.

For the smoke configs of h2o-danube-3-4b, gemma3-1b, mamba2-130m,
zamba2-7b, mixtral-8x7b and musicgen-large (embeddings in), with the
same (carried) weights and the same inputs: the loss equals ``jax.value_and_grad`` of the reference's
loss within 1e-5 (relative), and every gradient leaf, stacked as the
reference's, within 1e-4 of that leaf's largest magnitude.  One whole
``make_train_step`` (AdamW; Adafactor on kimi-k2), and one with
``microbatch=2``, leaves parameters and optimizer state within 1e-5 of
the reference's.  ``remat`` "full" and "none" give the same gradients,
and the two kernels' autograd Functions pass ``gradcheck`` in float64
with the plain version standing in for the kernel.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, smoke
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import Transformer as JTransformer
from repro.models import tree_init
from repro.models.layers import cross_entropy_loss as jcross_entropy_loss
from repro.optim import OptimizerConfig as JOptimizerConfig
from repro.optim import make_optimizer as jmake_optimizer
from repro_torch.carry import jax_params, load_jax_params, param_leaves
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import smoke as tsmoke
from repro_torch.kernels.flash_attention import attention_ref
from repro_torch.kernels.flash_attention.ops import FlashAttention
from repro_torch.kernels.ssd import ssd_chunks_ref
from repro_torch.kernels.ssd.ops import SSDChunks
from repro_torch.launch.steps import make_train_step
from repro_torch.models import Transformer
from repro_torch.models.layers import cross_entropy_loss
from repro_torch.optim import OptimizerConfig, make_optimizer

torch.set_num_threads(1)

B, S = 2, 32
ARCHS = ["h2o-danube-3-4b", "gemma3-1b", "mamba2-130m", "zamba2-7b",
         "mixtral-8x7b", "musicgen-large"]  # the last takes embeddings


def build(arch, **over):
    cfg = replace(smoke(get_config(arch)), **over)
    tcfg = replace(tsmoke(tget_config(arch)), **over)
    jm = JTransformer(cfg)
    params = tree_init(jm.param_specs(), jax.random.key(0), jnp.float32)
    model = Transformer(tcfg, device="cpu", seed=1)
    load_jax_params(model, jax.tree.map(np.asarray, params))
    return jm, params, model


def batch(cfg, seed=0, b=B):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, S)).astype(np.int32)
    data = {"labels": (toks + 1) % cfg.vocab}
    if cfg.stub_frontend is not None:
        data["embeds"] = rng.standard_normal(
            (b, S, cfg.d_model)).astype(np.float32)
    else:
        data["tokens"] = toks
    return data


def inputs(data, port: bool) -> dict:
    key = "embeds" if "embeds" in data else "tokens"
    return {key: torch.from_numpy(data[key]) if port
            else jnp.asarray(data[key])}


def get(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return np.asarray(tree)


def port_grads(model, data):
    model.trainable(True)
    logits = model.forward_train(**inputs(data, True))
    loss = cross_entropy_loss(logits, torch.from_numpy(data["labels"]))
    loss.backward()
    grads = {leaf.path: np.stack([p.grad.numpy() for p in leaf.parts])
             .reshape(leaf.shape) for leaf in param_leaves(model)}
    return float(loss), grads


def assert_leafwise(got: dict, want, tol, what):
    for path, g in got.items():
        w = get(want, path)
        assert g.shape == w.shape, path
        err = np.abs(g - w).max()
        assert err <= tol * max(np.abs(w).max(), 1e-30), \
            f"{what} {path}: {err} vs max {np.abs(w).max()}"


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    jm, params, model = build(arch)
    data = batch(model.cfg)

    def loss_fn(p):
        logits = jm.forward_train(p, **inputs(data, False))
        return jcross_entropy_loss(logits, jnp.asarray(data["labels"]))

    jl, jg = jax.jit(jax.value_and_grad(loss_fn))(params)
    tl, tg = port_grads(model, data)
    assert abs(tl - float(jl)) <= 1e-5 * abs(float(jl)), (tl, float(jl))
    assert set(tg) == {"/".join(str(getattr(k, "key", k)) for k in p)
                       for p, _ in jax.tree_util.tree_flatten_with_path(
                           jg)[0]}
    assert_leafwise(tg, jg, 1e-4, "grad")


def torch_tree(state):
    if isinstance(state, dict):
        return {k: torch_tree(v) for k, v in state.items()}
    return state.numpy()


@pytest.mark.parametrize("arch,opt,microbatch", [
    ("h2o-danube-3-4b", "adamw", 1),
    ("zamba2-7b", "adamw", 2),
    ("kimi-k2-1t-a32b", "adafactor", 1),
])
def test_train_step_matches_reference(arch, opt, microbatch):
    """Two whole steps: parameters, optimizer state and metrics."""
    jm, params, model = build(arch)
    kw = dict(name=opt, warmup_steps=2, decay_steps=10)
    jstep = jax.jit(jmake_train_step(jm, JOptimizerConfig(**kw),
                                     microbatch=microbatch))
    jinit, _ = jmake_optimizer(JOptimizerConfig(**kw))
    tcfg = OptimizerConfig(**kw)
    tinit, _ = make_optimizer(tcfg)
    tstep = make_train_step(model, tcfg, microbatch=microbatch)
    jstate = jinit(params)
    tstate = tinit(param_leaves(model))
    for i in range(2):
        data = batch(model.cfg, seed=i, b=2 * microbatch)
        params, jstate, jm_ = jstep(params, jstate,
                                    jax.tree.map(jnp.asarray, data))
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v)
                                    for k, v in data.items()})
        for k in ("loss", "lr", "grad_norm"):
            assert abs(float(tm[k]) - float(jm_[k])) <= \
                1e-5 * abs(float(jm_[k])), (i, k)
        got = {p: v for p, v in _flat(jax_params(model))}
        assert_leafwise(got, params, 1e-5, f"step {i} param")
        got = {p: v for p, v in _flat(torch_tree(tstate))}
        jflat = dict(_flat(jax.tree.map(np.asarray, jstate)))
        assert set(got) == set(jflat)
        for p, v in got.items():
            w = jflat[p]
            assert v.shape == w.shape and v.dtype == w.dtype, p
            np.testing.assert_allclose(
                v, w, rtol=0, atol=1e-5 * max(np.abs(w).max(), 1e-30),
                err_msg=f"step {i} state {p}")


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("arch", ["zamba2-7b", "h2o-danube-3-4b"])
def test_remat_does_not_change_gradients(arch):
    data = batch(tsmoke(tget_config(arch)))
    got = {}
    for remat in ("full", "none"):
        _, _, model = build(arch, remat=remat)
        got[remat] = port_grads(model, data)
    assert got["full"][0] == pytest.approx(got["none"][0], rel=1e-6)
    for path, g in got["full"][1].items():
        w = got["none"][1][path]
        assert np.abs(g - w).max() <= 1e-5 * max(np.abs(w).max(), 1e-30), \
            path


def test_ssd_function_gradcheck():
    """The SSD Function, its launcher the plain version: the backward
    (the plain version's VJP) is the forward's Jacobian."""
    g = torch.Generator().manual_seed(0)
    b, s, h, p, n, q = 1, 8, 2, 3, 4, 4
    f64 = torch.float64
    x = torch.randn(b, s, h, p, generator=g, dtype=f64)
    Bm, Cm = (torch.randn(b, s, n, generator=g, dtype=f64) for _ in "BC")
    dt = torch.rand(b, s, h, generator=g, dtype=f64) * 0.1 + 1e-3
    A = -(torch.rand(h, generator=g, dtype=f64) * 15 + 1)
    dac = torch.cumsum((dt * A).reshape(b, s // q, q, h), 2).reshape(b, s, h)
    plain = lambda x, dac, dt, B, C, chunk: ssd_chunks_ref(x, dac, dt, B, C,
                                                          chunk=chunk)
    args = [t.clone().requires_grad_() for t in (x, dac, dt, Bm, Cm)]
    assert torch.autograd.gradcheck(
        lambda *a: SSDChunks.apply(plain, q, *a), args)
    y, st = SSDChunks.apply(plain, q, *args)
    assert y.grad_fn is not None and st.grad_fn is not None


@pytest.mark.parametrize("causal,window,hkv", [(True, None, 2),
                                                (True, 3, 1),
                                                (False, None, 4)])
def test_flash_function_gradcheck(causal, window, hkv, monkeypatch):
    """The flash Function, its launcher the plain version; the backward
    goes a KV head at a time (a tiny slice budget) and equals the
    forward's Jacobian."""
    from repro_torch.kernels.flash_attention import ops
    monkeypatch.setattr(ops, "VJP_SCORE_BYTES", 1)
    g = torch.Generator().manual_seed(1)
    f64 = torch.float64
    q = torch.randn(2, 6, 4, 5, generator=g, dtype=f64)
    k, v = (torch.randn(2, 6, hkv, 5, generator=g, dtype=f64)
            for _ in "kv")
    plain = lambda q, k, v, scale, causal, window: attention_ref(
        q, k, v, scale=scale, causal=causal, window=window)
    args = [t.clone().requires_grad_() for t in (q, k, v)]
    assert torch.autograd.gradcheck(
        lambda *a: FlashAttention.apply(plain, None, causal, window, *a),
        args)


@pytest.mark.parametrize("arch", ["zamba2-7b", "gemma3-1b", "musicgen-large",
                                  "mixtral-8x7b"])
@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k",
                                        "decode_32k", "long_500k"])
def test_input_specs_match_reference(arch, shape_name):
    """Shapes and types of every step input, the decode cache's from
    ``init_cache`` on the meta device (no memory at 32 K positions)."""
    from repro.configs import SHAPES
    from repro.launch.steps import input_specs as jinput_specs
    from repro.launch.steps import serve_cache_len as jserve_cache_len
    from repro_torch.configs import SHAPES as TSHAPES
    from repro_torch.launch.steps import input_specs, serve_cache_len
    cfg, tcfg = smoke(get_config(arch)), tsmoke(tget_config(arch))
    shape, tshape = SHAPES[shape_name], TSHAPES[shape_name]
    assert serve_cache_len(tcfg, tshape) == jserve_cache_len(cfg, shape)
    want = dict(_flat(jinput_specs(cfg, shape, JTransformer(cfg))))
    got = dict(_flat(input_specs(tcfg, tshape,
                                 Transformer(tcfg, device="cpu"))))
    assert set(got) == set(want)
    for k, v in got.items():
        assert v.device.type == "meta", k
        assert tuple(v.shape) == want[k].shape, k
        assert str(v.dtype).split(".")[1] == str(want[k].dtype), k
