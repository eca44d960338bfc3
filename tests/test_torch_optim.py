"""The port's optimizers against ``repro.optim.optimizer`` on the CPU.

The tree is the reference's stacked layout: a 1-D leaf, a 2-D one, a
(G, per, d) norm weight stacked over groups and a (L, E, D, F) expert
leaf stacked over layers; the port holds the stacked ones as per-layer
tensors (``carry.Leaf``).  Three steps of AdamW and Adafactor leave
parameters and state within 1e-6 of the reference's (f32), or within
one bf16 step of each value (bf16 parameters, one cast back from f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizer as jopt
from repro_torch.carry import Leaf
from repro_torch.optim import optimizer as topt

torch.set_num_threads(1)

SHAPES = {"norm": ((), (24,)), "mat": ((), (12, 20)),
          "groups/ln": ((3, 2), (16,)), "layers/w": ((2,), (3, 8, 6))}


def tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(lead + shp) * scale).astype(np.float32)
            for k, (lead, shp) in SHAPES.items()}


def nested(flat):
    out = {}
    for k, v in flat.items():
        *head, last = k.split("/")
        node = out
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return out


def leaves_of(flat, dtype, per_layer=False):
    """Port leaves of a stacked numpy tree; ``per_layer`` makes every
    layer a leaf of its own (the transliteration the reference's
    layout rules out)."""
    out = []
    for k, (lead, shp) in SHAPES.items():
        parts = [torch.from_numpy(a.copy()).to(dtype) for a in
                 flat[k].reshape((-1,) + shp)]
        if per_layer:
            out += [Leaf(f"{k}/{i}", (), [p]) for i, p in enumerate(parts)]
        else:
            out.append(Leaf(k, lead, parts))
    return out


def stacked(leaves):
    return {leaf.path: torch.stack(leaf.parts).float().numpy()
            .reshape(leaf.shape) for leaf in leaves}


def flat_state(state, prefix=""):
    out = {}
    for k, v in state.items():
        if isinstance(v, dict):
            out.update(flat_state(v, f"{prefix}{k}/"))
        else:
            if isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16:
                v = v.float()
            out[prefix + k] = np.asarray(v)
    return out


@pytest.mark.parametrize("step", [0, 1, 9, 10, 500, 1000])
def test_lr_schedule(step):
    cfg = dict(warmup_steps=10, decay_steps=1000)
    want = jopt.lr_schedule(jopt.OptimizerConfig(**cfg),
                            jnp.asarray(step, jnp.int32))
    got = topt.lr_schedule(topt.OptimizerConfig(**cfg),
                           torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(float(want), rel=1e-6)


@pytest.mark.parametrize("scale", [1e-3, 1.0])
def test_global_norm_and_clip(scale):
    g = tree(3, scale)
    jg = nested({k: jnp.asarray(v) for k, v in g.items()})
    leaves = leaves_of(g, torch.float32)
    parts = [leaf.parts for leaf in leaves]
    assert float(topt.global_norm(parts)) == pytest.approx(
        float(jopt.global_norm(jg)), rel=1e-6)
    jclipped, jnorm = jopt.clip_by_global_norm(jg, 1.0)
    factor, norm = topt.clip_by_global_norm(parts, 1.0)
    assert float(norm) == pytest.approx(float(jnorm), rel=1e-6)
    want_flat = flat_state(jclipped)
    for leaf in leaves:
        want = want_flat[leaf.path]
        got = (torch.stack(leaf.parts) * factor).numpy().reshape(leaf.shape)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def run_both(name, dtype, per_layer=False, steps=3):
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    cfg = dict(name=name, warmup_steps=2, decay_steps=20, lr=1e-2)
    p0 = tree(0)
    jp = nested({k: jnp.asarray(v, jdt) for k, v in p0.items()})
    # The port starts from the same (rounded) values.
    p0 = {k: np.asarray(jnp.asarray(v, jdt).astype(jnp.float32))
          for k, v in p0.items()}
    leaves = leaves_of(p0, dtype, per_layer)
    jinit, jupd = jopt.make_optimizer(jopt.OptimizerConfig(**cfg))
    tinit, tupd = topt.make_optimizer(topt.OptimizerConfig(**cfg))
    js, ts = jinit(jp), tinit(leaves)
    for i in range(steps):
        g = tree(10 + i, 0.3)
        jg = nested({k: jnp.asarray(v, jdt) for k, v in g.items()})
        jp, js, jinfo = jupd(jp, jg, js)
        tg = [leaf.parts for leaf in leaves_of(g, dtype, per_layer)]
        ts, tinfo = tupd(leaves, tg, ts)
        assert float(tinfo["grad_norm"]) == pytest.approx(
            float(jinfo["grad_norm"]), rel=1e-6)
    jflat = {k: np.asarray(jnp.asarray(v).astype(jnp.float32))
             for k, v in flat_state(jp).items()}
    return jflat, flat_state(js), leaves, ts


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_updates_match_reference_f32(name):
    jp, js, leaves, ts = run_both(name, torch.float32)
    for path, got in stacked(leaves).items():
        np.testing.assert_allclose(got, jp[path], rtol=0,
                                   atol=1e-6, err_msg=path)
    tflat = flat_state(ts)
    assert set(tflat) == set(js)
    for k, want in js.items():
        assert tflat[k].shape == want.shape, k
        np.testing.assert_allclose(tflat[k], want, rtol=0,
                                   atol=1e-6 * max(1.0, np.abs(want).max()),
                                   err_msg=k)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_updates_match_reference_bf16(name):
    """bf16 parameters: f32 math and one cast back, so each value is the
    reference's or a neighbour in bf16."""
    jp, js, leaves, ts = run_both(name, torch.bfloat16)
    for path, got in stacked(leaves).items():
        want = jp[path]
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-6,
                                   err_msg=path)
        assert np.mean(got == want) > 0.99, path


def test_per_layer_factoring_would_differ():
    """A port that kept the optimizer per layer would make a (G, per, d)
    norm weight d-vectors (unfactored, each clipped on its own): its
    step differs from the reference's, which the stacked leaves match."""
    jp, _, leaves, _ = run_both("adafactor", torch.float32)
    jp2, _, per_layer, _ = run_both("adafactor", torch.float32,
                                    per_layer=True)
    want = jp["groups/ln"]
    got = stacked(leaves)["groups/ln"]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    wrong = np.stack([leaf.parts[0].numpy() for leaf in per_layer
                      if leaf.path.startswith("groups/ln/")]).reshape(
        want.shape)
    assert np.abs(wrong - want).max() > 1e-4
