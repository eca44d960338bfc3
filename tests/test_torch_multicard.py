"""The port sharded on DeviceMeshes of 4 CPU processes against the JAX
package.

One spawned 4-rank ``gloo`` world (``torch_mesh_cells.mesh_program``)
runs, on a ('data', 'model') = (2, 2) mesh (``test_torch_multicard_pod``
runs the same tests on a ('pod', 'data', 'model') = (2, 1, 2) mesh, in
a world of its own so that the two files run side by side), the smoke
configs of h2o-danube-3-4b, mixtral-8x7b and zamba2-7b, and two with
their query heads sharded over 'model' and the K/V heads replicated
(``cells.CASES``: each rank selects the K/V heads of its query heads,
with 1 or 2 query heads a K/V head), with parameters, AdamW state and batch
placed by ``tree_shardings`` / ``opt_state_shardings`` /
``batch_shardings`` as DTensors: one ``make_train_step`` on carried
weights equals the reference's jitted step on the same weights and
batch (loss 1e-5 relative; every state leaf within 1e-5 of its
largest magnitude; every parameter within 1e-5 of its leaf's largest
magnitude where Adam's update is well conditioned, and everywhere the
AdamW update of the rank's own state), a prefill equals the unsharded
port's within 1e-5, and a checkpoint restored with ``shardings=`` puts
each leaf on its sharding.  No rank imports jax or repro.

Why the parameters have two checks: the first AdamW step moves a
parameter by lr * g / (|g| + eps) (bias-corrected), so where a
gradient element is within a few eps of 0 its update depends on the
element's last bits, and the summation order (XLA against torch, one
rank against four) shifts it by up to lr * 1e-2.  Where the reference's
|g| is below ``COND`` x eps (and not 0: rows no token reaches only
decay) the parameter is held to the update of its own
(reference-matching) state instead.
"""

import os
import threading
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_cells as cells
from repro.configs import get_config, smoke
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import Transformer as JTransformer
from repro.models import tree_init
from repro.optim import OptimizerConfig as JOptimizerConfig
from repro.optim import make_optimizer as jmake_optimizer
from repro_torch.carry import load_jax_params
from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import smoke as tsmoke
from repro_torch.models import Transformer

torch.set_num_threads(1)

B, S = 4, 32
TOL = 1e-5
COND = 10  # |g| / eps above which Adam's step-1 update is well conditioned
MESH = "data2_model2"


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    return {"tokens": toks, "labels": ((toks + 1) % cfg.vocab)
            .astype(np.int32)}


def _reference(arch, params, data):
    """The JAX package's jitted AdamW step, and the unsharded port's
    prefill, on the same weights and batch."""
    cfg = cells.case_config(arch, get_config, smoke)
    jm = JTransformer(cfg)
    opt = JOptimizerConfig(**cells.OPT)
    new, state, metrics = jax.jit(jmake_train_step(jm, opt))(
        params, jmake_optimizer(opt)[0](params),
        jax.tree.map(jnp.asarray, data))
    model = Transformer(cells.case_config(arch, tget_config, tsmoke),
                        device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, params))
    logits, cache = model.prefill(tokens=torch.from_numpy(data["tokens"]))
    return {"params": dict(_flat(new)), "state": dict(_flat(state)),
            "p0": {k: np.asarray(v, np.float64)
                   for k, v in _flat(params)},
            "metrics": {k: float(v) for k, v in metrics.items()},
            "logits": logits.numpy(),
            "cache": {k: v.numpy() for k, v in cache.items()}}


def pytest_generate_tests(metafunc):
    """``arch`` runs over the cases of this module's mesh."""
    if "arch" in metafunc.fixturenames:
        metafunc.parametrize("arch", cells.MESH_RUNS[metafunc.module.MESH])


@pytest.fixture(scope="module")
def mesh(request):
    """The mesh of this module's world (a key of ``cells.MESHES``)."""
    return request.module.MESH


@pytest.fixture(scope="module")
def runs(tmp_path_factory, mesh):
    """The world's results and the references, computed while the
    ranks run."""
    d = str(tmp_path_factory.mktemp("mesh"))
    inputs = {}
    for i, arch in enumerate(cells.MESH_RUNS[mesh]):
        cfg = cells.case_config(arch, get_config, smoke)
        params = tree_init(JTransformer(cfg).param_specs(),
                           jax.random.key(i), jnp.float32)
        data = _batch(cfg, i)
        np.savez(os.path.join(d, f"{arch}.params.npz"), **dict(_flat(params)))
        np.savez(os.path.join(d, f"{arch}.batch.npz"), **data)
        inputs[arch] = (params, data)
    CheckpointManager(os.path.join(d, "ckpt")).save(
        1, {"w": torch.arange(16.0).reshape(4, 4),
            "nested": {"b": torch.arange(6.0)}}, extra={"step": 1},
        blocking=True)
    world, err = {}, []

    def spawn():
        try:
            world.update(cells.run_world(cells.mesh_program, (d, mesh),
                                         timeout=300))
        except Exception as e:  # surfaced below
            err.append(e)

    t = threading.Thread(target=spawn)
    t.start()
    refs = {arch: _reference(arch, *inputs[arch]) for arch in inputs}
    t.join()
    if err:
        raise err[0]
    return world, refs


def _close(got, want, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= TOL * max(np.abs(want).max(), 1e-30), \
        f"{what}: {err} vs max {np.abs(want).max()}"


def test_train_step_metrics_match_reference(runs, mesh, arch):
    world, refs = runs
    for k in ("loss", "lr", "grad_norm"):
        want = refs[arch]["metrics"][k]
        got = world[f"{mesh}/{arch}/metric/{k}"]
        assert abs(got - want) <= TOL * abs(want), (k, got, want)


def _adamw(p0, mu, nu, metrics):
    """The first AdamW step's parameter from its state (numpy, f64)."""
    opt = JOptimizerConfig(**cells.OPT)
    delta = (mu / (1 - opt.b1)) / (np.sqrt(nu / (1 - opt.b2)) + opt.eps) \
        + opt.weight_decay * p0
    return p0 - metrics["lr"] * delta


def test_train_step_params_match_reference(runs, mesh, arch):
    world, refs = runs
    ref = refs[arch]
    want = ref["params"]
    got = {k.split("/param/", 1)[1]: v for k, v in world.items()
           if k.startswith(f"{mesh}/{arch}/param/")}
    assert set(got) == set(want)
    eps = JOptimizerConfig(**cells.OPT).eps
    for path, v in got.items():
        w = np.asarray(want[path], np.float64)
        g = np.abs(ref["state"]["mu/" + path] / (1 - JOptimizerConfig().b1))
        ok = (g == 0) | (g >= COND * eps)  # no gradient: decay alone
        assert ok.mean() > 0.5, (path, ok.mean())
        _close(np.where(ok, v, w), w, f"param {path}")
        own = _adamw(ref["p0"][path],
                     world[f"{mesh}/{arch}/state/mu/{path}"],
                     world[f"{mesh}/{arch}/state/nu/{path}"], ref["metrics"])
        _close(v, own, f"param {path} from its own state")


def test_train_step_state_matches_reference_and_stays_placed(runs, mesh,
                                                               arch):
    world, refs = runs
    want = refs[arch]["state"]
    got = {k.split("/state/", 1)[1]: v for k, v in world.items()
           if k.startswith(f"{mesh}/{arch}/state/")}
    assert set(got) == set(want)
    for path, v in got.items():
        _close(v, want[path], f"state {path}")
    assert world[f"{mesh}/{arch}/placed"]


def test_prefill_matches_unsharded_port(runs, mesh, arch):
    world, refs = runs
    _close(world[f"{mesh}/{arch}/prefill/logits"], refs[arch]["logits"],
           "logits")
    for k, want in refs[arch]["cache"].items():
        _close(world[f"{mesh}/{arch}/prefill/cache/{k}"], want, f"cache {k}")


@pytest.mark.parametrize("case", tuple(cells.CASES))
def test_query_head_cases_select_kv_heads(runs, mesh, case):
    """The cases whose query heads are sharded put them on 'model' with
    the K/V projections replicated, and the kernels' local shards
    select K/V heads (the other cases shard head_dim and select none)."""
    world, _ = runs
    assert world[f"{mesh}/{case}/heads_placed"] == [True, True]
    assert world[f"{mesh}/{case}/selections"] > 0
    for arch in cells.ARCHS:
        assert world[f"{mesh}/{arch}/selections"] == 0, arch


def test_elastic_restore_places_each_leaf(runs, mesh):
    """``test_runtime.py``'s elastic restore, on each mesh."""
    world, _ = runs
    assert world[f"{mesh}/restore/placed"] == [True, True]
    np.testing.assert_array_equal(world[f"{mesh}/restore/w"],
                                  np.arange(16.0).reshape(4, 4))
    np.testing.assert_array_equal(world[f"{mesh}/restore/b"],
                                  np.arange(6.0))
    assert world[f"{mesh}/restore/extra"] == {"step": 1}
