"""The port's roofline, report and dry-run tools against
``repro.analysis`` and ``repro.launch.dryrun``.

The reference's analysis cases that parse no HLO (the roofline terms
and bottleneck, ``report.load`` and its tables) hold on the port with
the H100 constants; ``trace_report`` of both packages gives equal
dicts on the same events, and over a CPU ``Engine``'s trace tells the
pipeline's story (``test_obs.py``'s counterpart); and ``dryrun.
lower_cell`` on smoke configs over a (2, 2) fake mesh gives the
``argument_bytes`` the reference's ``memory_analysis()`` gives for the
same shardings on 4 host devices, and its ``model_flops``, ``params``
and ``active_params``.
"""

import json
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis.report import trace_report as jtrace_report
from repro.configs import get_config, smoke
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.launch.mesh import make_mesh_compat as jmake_mesh
from repro.launch.steps import (adjust_rules_for_shape, batch_shardings,
                                input_specs, make_decode_step,
                                make_prefill_step, make_train_step,
                                opt_state_shardings, serve_cache_len)
from repro.models import Transformer as JTransformer
from repro.models import tree_abstract, tree_shardings
from repro.optim.optimizer import OptimizerConfig as JOptimizerConfig
from repro.optim.optimizer import make_optimizer as jmake_optimizer
from repro_torch import obs
from repro_torch.analysis import report
from repro_torch.analysis.roofline import RooflineReport
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import smoke as tsmoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.engine import Engine, EngineConfig
from repro_torch.engine.plan import OpBatch
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16
from repro_torch.lsm import LSMConfig

torch.set_num_threads(1)

UNIVERSE = 1 << 20
# (arch, kind, seq, batch): a hybrid train step, an MoE prefill, a dense
# decode against a cache.
CELLS = [("zamba2-7b", "train", 32, 4), ("mixtral-8x7b", "prefill", 64, 4),
         ("h2o-danube-3-4b", "decode", 64, 4)]
NAMES = {"train": "train_4k", "prefill": "prefill_32k",
         "decode": "decode_32k"}


# ------------------------------------------------------------- roofline
def test_roofline_terms_and_bottleneck():
    r = RooflineReport(arch="a", shape="s", mesh="single", chips=256,
                       hlo_flops=256 * PEAK_FLOPS_BF16 * 2.0,
                       hlo_bytes=256 * HBM_BW * 1.0,
                       coll_bytes=256 * NVLINK_BW * 0.5,
                       model_flops=256 * PEAK_FLOPS_BF16 * 1.0)
    assert (r.peak_flops, r.hbm_bw, r.ici_bw) == (989e12, 3.35e12, 450e9)
    assert abs(r.t_compute - 2.0) < 1e-9
    assert abs(r.t_memory - 1.0) < 1e-9
    assert abs(r.t_collective - 0.5) < 1e-9
    assert r.bottleneck == "compute"
    assert abs(r.roofline_fraction - 1.0) < 1e-9
    assert abs(r.useful_flops_ratio - 0.5) < 1e-9
    d = r.to_dict()
    assert d["bottleneck"] == "compute" and d["t_memory"] == r.t_memory


def test_step_counter_matches_a_hand_count_on_two_ranks():
    """``StepCounter`` on rank 0 of a 2-rank fake mesh, under
    ``FakeTensorMode``: y = x @ w with w (64, 32) column-sharded and x
    (8, 64) replicated, y all-gathered to a replicated z, and the
    backward of z.sum() to w.  Every count is worked out by hand from
    the local shards (f32, 4 bytes an element)."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.analysis.roofline import StepCounter, analyze_counts
    from repro_torch.launch.mesh import make_mesh_compat

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=2)
    try:
        mesh = make_mesh_compat((2,), ("model",), device_type="cpu")
        with FakeTensorMode():
            w = distribute_tensor(torch.empty(64, 32), mesh,
                                  [Shard(1)]).requires_grad_()
            x = distribute_tensor(torch.empty(8, 64), mesh, [Replicate()])
            with StepCounter() as c:
                y = x @ w
                z = y.redistribute(mesh, [Replicate()])
                z.sum().backward()
                del y, z
    finally:
        dist.destroy_process_group()
    x_, w_, y_ = 8 * 64 * 4, 64 * 16 * 4, 8 * 16 * 4  # local bytes
    z_ = 8 * 32 * 4
    # Two local (8, 64) x (64, 16) products: y, and w's gradient x^T @ dy.
    assert c.flops == 2 * (2 * 8 * 64 * 16)
    # One all-gather of y's local shard.
    assert c.coll == {"all-gather": y_}
    # Bytes read and written by the ops that are not views: the forward
    # mm, the all-gather (y in, (16, 16) out), the cat that lays the
    # gathered rows out as (8, 32), the sum, ones_like for its
    # gradient, the clone of dz's local half, the backward mm.
    assert c.bytes == (x_ + w_ + y_) + (y_ + 2 * y_) + (2 * y_ + z_) \
        + (z_ + 4) + (4 + 4) + (y_ + y_) + (x_ + y_ + w_)
    # At the peak y, z, the loss, its ones, the local dz and w's
    # gradient are alive; x's transpose is a view (nothing allocated),
    # and the gathered (16, 16) buffer died with the redistribution.
    assert c.peak == y_ + z_ + 4 + 4 + y_ + w_
    assert c.live == w_  # w's gradient outlives the step
    rep = analyze_counts(c, arch="a", shape="s", mesh_name="m", chips=2,
                         model_flops=0.0)
    assert (rep.hlo_flops, rep.hlo_bytes, rep.coll_bytes) == (
        2 * c.flops, 2 * c.bytes, 2 * y_)


# ------------------------------------------------------------- dry-run
def _jax_argument_bytes(arch, shape):
    """The reference's lowering of a cell on a (2, 2) mesh of 4 host
    devices, as ``repro.launch.dryrun.lower_cell`` lowers it."""
    cfg = smoke(get_config(arch))
    m = JTransformer(cfg)
    specs = m.param_specs()
    mesh = jmake_mesh((2, 2), ("data", "model"))
    adjust_rules_for_shape(m, shape, mesh)
    rules = m.rules
    pa = tree_abstract(specs, jnp.dtype(cfg.dtype))
    psh = tree_shardings(specs, mesh, rules)
    ba = input_specs(cfg, shape, m)
    bsh = batch_shardings(cfg, shape, mesh, rules, m)
    with mesh:
        if shape.kind == "train":
            oc = JOptimizerConfig(name=cfg.optimizer)
            oa = jax.eval_shape(jmake_optimizer(oc)[0], pa)
            osh = opt_state_shardings(cfg.optimizer, specs, mesh, rules)
            low = jax.jit(make_train_step(m, oc),
                          in_shardings=(psh, osh, bsh),
                          donate_argnums=(0, 1)).lower(pa, oa, ba)
        elif shape.kind == "prefill":
            low = jax.jit(make_prefill_step(m),
                          in_shardings=(psh, bsh)).lower(pa, ba)
        else:
            _, ring = serve_cache_len(cfg, shape)
            low = jax.jit(make_decode_step(m, ring=ring), in_shardings=(
                psh, bsh["token"], bsh["cache"], bsh["pos"]),
                donate_argnums=(2,)).lower(
                    pa, ba["token"], ba["cache"],
                    jax.ShapeDtypeStruct((), jnp.int32))
    return low.compile().memory_analysis().argument_size_in_bytes


@pytest.fixture(scope="module")
def cells():
    out = {}
    for arch, kind, s, b in CELLS:
        name = NAMES[kind]
        out[arch] = dryrun.lower_cell(
            arch, name, "single", cfg=tsmoke(tget_config(arch)),
            shape=ShapeConfig(name, kind, s, b), mesh_shape=(2, 2))
    return out


@pytest.mark.parametrize("arch,kind,s,b", CELLS)
def test_dryrun_argument_bytes_match_reference(cells, arch, kind, s, b):
    want = _jax_argument_bytes(arch, JShapeConfig(NAMES[kind], kind, s, b))
    assert cells[arch]["memory_per_device"]["argument_bytes"] == want


@pytest.mark.parametrize("arch,kind,s,b", CELLS)
def test_dryrun_model_counts_match_reference(cells, arch, kind, s, b):
    from repro.launch.dryrun import model_flops
    cfg = smoke(get_config(arch))
    res = cells[arch]
    assert res["model_flops"] == model_flops(
        cfg, JShapeConfig(NAMES[kind], kind, s, b))
    assert (res["params"], res["active_params"]) == (
        cfg.n_params(), cfg.n_active_params())
    assert res["chips"] == 4 and res["hlo_flops"] > 0
    assert res["hlo_bytes"] > 0 and res["coll_bytes"] > 0
    assert res["memory_per_device"]["temp_bytes"] > 0
    assert res["fits_80g"] and res["bottleneck"] in (
        "compute", "memory", "collective")
    json.dumps(res)


def test_report_loads_results_and_renders_tables(cells, tmp_path, capsys):
    for arch, res in cells.items():
        (tmp_path / f"{arch}.json").write_text(json.dumps(res))
    rows = report.load(str(tmp_path))
    assert len(rows) == len(CELLS)
    t1 = report.dryrun_table(rows)
    t2 = report.roofline_table(rows)
    assert "| arch |" in t1 and "fits 80G" in t1 and "bottleneck" in t2
    assert all(a in t1 and a in t2 for a in cells)
    assert report.fmt_s(2.5) == "2.50s" and report.fmt_b(3e9) == "3.00GB"
    import sys
    old = sys.argv
    sys.argv = ["report", str(tmp_path)]
    try:
        report.main()
    finally:
        sys.argv = old
    assert "§Roofline" in capsys.readouterr().out


# ---------------------------------------------------------------- traces
def _engine():
    eng = Engine(num_shards=2, strategy="gloran",
                 lsm_config=LSMConfig(buffer_capacity=64, size_ratio=3,
                                      key_size=16, value_size=48,
                                      block_size=512, key_universe=UNIVERSE),
                 config=EngineConfig(device="cpu", procs=0))
    keys = np.arange(0, 4000, 2, dtype=np.uint64)
    eng.put_batch(keys, keys + np.uint64(1))
    eng.flush()
    return eng, keys


@pytest.fixture(scope="module")
def trace():
    eng, keys = _engine()
    with obs.enabled() as tr:
        for i in range(3):
            eng.submit(OpBatch.gets(keys[i * 300:(i + 1) * 300])) \
                .get_results()
        eng.drain()
    return tr.chrome_events()


def test_trace_report_stalls_and_critical_path(trace):
    rep = report.trace_report(trace)
    assert len(rep["batches"]) == 3
    assert set(rep["shards"]) == {0, 1}
    share = sum(r["stall_share"] for r in rep["shards"].values())
    assert share == pytest.approx(1.0) or share == 0.0
    for b in rep["batches"]:
        assert b["critical_us"] <= b["window_us"] + 1e-9
    assert rep["wall_us"] >= rep["modeled_us"] - 1e-9
    assert rep["lookups"] == 900
    json.dumps(rep)
    assert "launches/lookup" in report.trace_tables(rep)


def test_trace_report_equals_reference_on_the_same_events(trace,
                                                          tmp_path):
    assert report.trace_report(trace) == jtrace_report(trace)
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": trace}))
    assert report.load_trace(str(path)) == json.loads(path.read_text())[
        "traceEvents"]
