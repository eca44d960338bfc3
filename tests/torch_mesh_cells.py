"""Rank programs of the mesh suites: ``repro_torch`` sharded on a
DeviceMesh over a world of CPU processes (``gloo``).

``run_world`` spawns the ranks, each of which runs one program and
returns what rank 0 gathered; the test modules hold the results
against the JAX package.  This module imports neither ``jax`` nor
``repro``: a rank imports it by name when it starts (spawn), and each
rank reports the JAX modules it holds at the end.
"""

from __future__ import annotations

import os
import sys
import tempfile
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

MESHES = {"data2_model2": ((2, 2), ("data", "model")),
          "pod2_data1_model2": ((2, 1, 2), ("pod", "data", "model"))}
ARCHS = ("h2o-danube-3-4b", "mixtral-8x7b", "zamba2-7b")
# Query heads sharded over 'model' with the K/V heads replicated, as
# mixtral-8x7b's 32 query heads over 16 ranks (8 K/V heads) lie on the
# production mesh: each rank selects the K/V heads its query heads read.
# (The smoke configs' 4 heads cannot split 16 ways, so their rules shard
# head_dim.)  With 4 query heads on 2 ranks, mixtral's 2 K/V heads are
# one a rank (whole groups); with 1 K/V head each rank reads it for each
# of its 2 query heads, as 2 query heads of a group of 4 do there.
Q_HEADS = {"q_heads": "model", "kv_heads": None, "head_dim": None}
CASES = {"mixtral-8x7b:q_heads": ("mixtral-8x7b", {}),
         "h2o-danube-3-4b:q_heads_mqa": ("h2o-danube-3-4b",
                                         {"n_kv_heads": 1})}
RUNS = ARCHS + tuple(CASES)
# The cases each mesh runs: the query-head cases need a 'model' axis of 2
# only, and DTensor's first propagations on the 3-D mesh are slow.
MESH_RUNS = {"data2_model2": RUNS, "pod2_data1_model2": ARCHS}


def case_config(case, get_config, smoke):
    """The smoke config of ``case`` (an arch, or a key of ``CASES``),
    with the ``get_config`` / ``smoke`` of either package."""
    from dataclasses import replace

    arch, kw = CASES.get(case, (case, None))
    cfg = smoke(get_config(arch))
    return cfg if kw is None else replace(cfg, sharding_overrides=Q_HEADS,
                                          **kw)
OPT = dict(name="adamw", warmup_steps=2, decay_steps=10)


def _rank_main(rank, world, init, program, args, queue):
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=init, world_size=world,
                                rank=rank)
        out = program(rank, *args)
        out["jax_modules"] = sorted(m for m in sys.modules if m.split(".")[0]
                                    in ("jax", "jaxlib", "repro"))
        dist.destroy_process_group()
        queue.put((rank, out, None))
    except Exception:  # reported to the parent, which raises it
        queue.put((rank, None, traceback.format_exc()))


def run_world(program, args=(), world: int = 4, timeout: float = 240.0):
    """Run ``program(rank, *args)`` (a function of this module) on
    ``world`` spawned gloo ranks; returns rank 0's result (each rank's
    ``jax_modules`` is checked to be empty)."""
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world, init, program, args, queue))
                 for r in range(world)]
        for p in procs:
            p.start()
        try:
            results = [queue.get(timeout=timeout) for _ in procs]
        finally:
            for p in procs:
                p.join(5)
                if p.is_alive():
                    p.kill()
    errors = [err for _, _, err in results if err]
    if errors:
        raise RuntimeError("rank failed:\n" + errors[0])
    for _, out, _ in results:
        if out["jax_modules"]:
            raise RuntimeError(f"a rank imported {out['jax_modules']}")
    return next(out for r, out, _ in results if r == 0)


# -------------------------------------------------------------- helpers
def full(t):
    """A tensor (DTensor or plain) as a numpy array of its whole value;
    collective for a DTensor: every rank calls it."""
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().float().numpy()


def flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def full_params(model) -> dict:
    """The model's parameters in the JAX package's stacked layout."""
    from repro_torch.carry import param_leaves
    return {leaf.path: np.stack([full(p) for p in leaf.parts])
            .reshape(leaf.shape) for leaf in param_leaves(model)}


def load_tree(path) -> dict:
    from repro_torch.carry import nest
    with np.load(path) as data:
        return nest({k: data[k] for k in data.files})


# ----------------------------------------------------- the mesh program
def mesh_program(rank, data_dir: str, mesh_name: str) -> dict:
    """On the mesh ``MESHES[mesh_name]``, for each of its ``MESH_RUNS``: a
    sharded prefill and one sharded AdamW train step on the weights and
    batch in ``data_dir``; then an elastic restore.  Rank 0 returns the
    whole values."""
    from repro_torch.carry import load_jax_params, param_leaves
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs import SHAPES, get_config, smoke
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.launch.steps import (batch_shardings, make_train_step,
                                          opt_state_shardings)
    from repro_torch.models import Transformer
    from repro_torch.models.params import distribute_tree
    from repro_torch.models.sharding import NamedSharding
    from repro_torch.optim import OptimizerConfig, adamw_init

    from repro_torch.kernels import sharded
    from torch.distributed.tensor import Replicate, Shard

    # Count the K/V head selections the kernels' local shards make.
    selections, plan = [], sharded.plan

    def counted(*a):
        got = plan(*a)
        selections.extend(s for s in got[2] if s is not None)
        return got

    sharded.plan = counted
    out = {}
    shape, names = MESHES[mesh_name]
    mesh = make_mesh_compat(shape, names, device_type="cpu")
    for arch in MESH_RUNS[mesh_name]:
        cfg = case_config(arch, get_config, smoke)
        tag = f"{mesh_name}/{arch}"
        model = Transformer(cfg, device="cpu")
        load_jax_params(model, load_tree(os.path.join(
            data_dir, f"{arch}.params.npz")))
        model.shard(mesh)
        if arch in CASES:
            leaf = {lf.path: lf.parts[0] for lf in param_leaves(model)}
            on = names.index("model")
            out[f"{tag}/heads_placed"] = [
                leaf["layers/attn/wq"].placements[on] == Shard(1),
                leaf["layers/attn/wk"].placements[on] == Replicate()]
        selections.clear()
        with np.load(os.path.join(data_dir, f"{arch}.batch.npz")) as d:
            batch = {k: torch.from_numpy(d[k]) for k in d.files}
        bsh = batch_shardings(cfg, SHAPES["train_4k"], mesh, model.rules,
                              model)
        batch = distribute_tree(batch, bsh)
        logits, cache = model.prefill(tokens=batch["tokens"])
        out[f"{tag}/prefill/logits"] = full(logits)
        for k, v in cache.items():
            out[f"{tag}/prefill/cache/{k}"] = full(v)
        opt = OptimizerConfig(**OPT)
        osh = opt_state_shardings("adamw", model.param_specs(), mesh,
                                  model.rules)
        state = distribute_tree(adamw_init(param_leaves(model)), osh)
        state, metrics = make_train_step(model, opt)(state, batch)
        for k, v in metrics.items():
            out[f"{tag}/metric/{k}"] = float(v)
        for path, v in full_params(model).items():
            out[f"{tag}/param/{path}"] = v
        for path, v in flat(state):
            out[f"{tag}/state/{path}"] = full(v)
        want = dict(flat(osh))
        out[f"{tag}/placed"] = all(
            tuple(t.placements) == want[path].placements
            for path, t in flat(state))
        out[f"{tag}/selections"] = len(selections)
    # The elastic restore: a checkpoint saved without a mesh lands
    # on this one, each leaf on its sharding.
    ckpt = CheckpointManager(os.path.join(data_dir, "ckpt"))
    template = {"w": torch.zeros(4, 4), "nested": {"b": torch.zeros(6)}}
    sh = {"w": NamedSharding(mesh, ("data", None)),
          "nested": {"b": NamedSharding(mesh, ("model",))}}
    got, extra = ckpt.restore(template, shardings=sh)
    out[f"{mesh_name}/restore/placed"] = [
        tuple(got["w"].placements) == sh["w"].placements,
        tuple(got["nested"]["b"].placements)
        == sh["nested"]["b"].placements]
    out[f"{mesh_name}/restore/w"] = full(got["w"])
    out[f"{mesh_name}/restore/b"] = full(got["nested"]["b"])
    out[f"{mesh_name}/restore/extra"] = extra
    return out if rank == 0 else {}


# ------------------------------------------------ compressed reduction
def psum_program(rank, grads: list, steps: int, solo: list,
                 solo_steps: int) -> dict:
    """``compressed_psum`` over a 2-rank 'pod' group: rank r reduces
    ``grads[r]`` (a list of arrays) ``steps`` times with error feedback;
    then rank 0 reduces ``solo`` alone ``solo_steps`` times over a
    1-rank group.  Rank 0 returns every step's reduced values and the
    solo run's sum of reductions."""
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.optim import compressed_psum

    mesh = make_mesh_compat((2,), ("pod",), device_type="cpu")
    g = [torch.from_numpy(a) for a in grads[rank]]
    e = [torch.zeros_like(a) for a in g]
    red = []
    for _ in range(steps):
        r, e = compressed_psum(g, e, mesh.get_group("pod"))
        red.append([x.numpy() for x in r])
    groups = [dist.new_group([r]) for r in range(2)]
    if rank:
        return {}
    g = [torch.from_numpy(a) for a in solo]
    e = [torch.zeros_like(a) for a in g]
    total = [torch.zeros_like(a) for a in g]
    for _ in range(solo_steps):
        r, e = compressed_psum(g, e, groups[0])
        total = [t + x for t, x in zip(total, r)]
    return {"reduced": red, "solo_total": [t.numpy() for t in total]}


# ---------------------------------------------------------- hygiene
def import_program(rank) -> dict:
    """Import every ``repro_torch`` module in a rank and run a sharded
    matmul through ``NamedSharding``: the rank's modules are checked by
    ``run_world``."""
    import importlib
    import pkgutil

    import repro_torch
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.models.sharding import NamedSharding

    for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        importlib.import_module(m.name)
    mesh = make_mesh_compat((2,), ("model",), device_type="cpu")
    w = NamedSharding(mesh, (None, "model")).distribute(torch.eye(4))
    x = NamedSharding(mesh, (None, None)).distribute(torch.ones(2, 4))
    y = (x @ w).full_tensor()
    return {"sum": float(y.sum())}
