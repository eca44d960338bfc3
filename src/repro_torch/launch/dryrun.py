"""Multi-pod dry-run: trace every (arch x shape x mesh) cell over a fake
process group (a port of ``repro.launch.dryrun``).

For each cell this proves the distribution config is coherent (the
rules' shardings compose and every op of the step partitions on the
production mesh) and records what the step costs on rank 0: its memory
(does it fit 80 GB a card?), its FLOPs and bytes, and the bytes of its
collectives, for the roofline (``analysis.roofline``).

Where the reference lowers and compiles ``jax.jit(step, in_shardings=...)``
for 256 or 512 host devices, a cell here:

  1. inits the ``"fake"`` process group of the mesh's size (a testing
     module of torch, ``torch.testing._internal.distributed.fake_pg``:
     collectives return at once and move no data);
  2. builds the production mesh on it and ``Transformer(cfg,
     device="meta")`` (no memory), fits its rules to the (shape x mesh)
     and applies the cell's variants;
  3. under ``FakeTensorMode`` (shapes, no data) places parameters,
     optimizer state, batch and cache as DTensors by their shardings;
  4. traces one train, prefill or decode step under
     ``roofline.StepCounter``, and destroys the group.

``argument_bytes`` is the exact sum of rank 0's local shard bytes of
the parameters, optimizer state and inputs; ``temp_bytes`` the peak of
the local bytes the traced step kept alive at once (its outputs among
them).  ``lower_s`` is the seconds the placement took, ``compile_s``
the traced step's.  The reference also compiles a one-layer unit and
adds (L - 1) of it, since ``cost_analysis`` counts a scanned layer body
once; the port's step runs every layer in Python, so its trace is
already whole and there is no unit.  The numbers are model estimates
from the H100 data sheet's constants, not measurements.

Usage:
  python -m repro_torch.launch.dryrun --arch mixtral-8x7b --shape train_4k \\
      --mesh multi --out results/
  python -m repro_torch.launch.dryrun --all --mesh both --out results/
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback

import torch
import torch.distributed as dist
from torch import nn

from ..analysis.roofline import StepCounter, analyze_counts
from ..carry import param_leaves
from ..configs import ARCHS, SHAPES, get_config
from ..configs.base import ModelConfig, ShapeConfig
from ..launch.mesh import HBM_BYTES, make_mesh_compat, production_shape
from ..launch.steps import (adjust_rules_for_shape, batch_shardings,
                            input_specs, make_train_step,
                            opt_state_shardings, serve_cache_len)
from ..models import Transformer
from ..models.params import distribute_tree
from ..optim.optimizer import OptimizerConfig, make_optimizer


def planned_cells():
    """All 40 (arch x shape) cells; long_500k runs only for sub-quadratic
    archs (skips recorded)."""
    for arch in ARCHS:
        cfg = get_config(arch)
        for sname, shape in SHAPES.items():
            skip = sname == "long_500k" and not cfg.sub_quadratic
            yield arch, sname, skip


def model_flops(cfg, shape) -> float:
    n = cfg.n_active_params()
    if shape.kind == "train":
        return 6.0 * n * shape.tokens
    return 2.0 * n * shape.tokens


def apply_variants(model: Transformer, variants, microbatch: int) -> int:
    """The reference's hill-climb knobs on ``model.rules``; returns the
    microbatch count.
      mb<k>     gradient accumulation over k microbatches
      ctxcache  context-parallel decode KV cache (seq dim over 'model')
      seqpar    sequence-parallel residual stream (seq over 'model')
      cponly    no tensor parallelism: 'model' carries the sequence
      moedecode shard the MoE dispatch buffer's d_model, not capacity
      nofsdp    serving: weights resident, model-sharded only
    """
    for v in variants:
        if v.startswith("mb"):
            microbatch = int(v[2:])
        elif v == "ctxcache":
            prev = model.rules.rules.get("cache_seq") or ()
            model.rules = model.rules.with_overrides(
                cache_dim=None,
                cache_seq=tuple(dict.fromkeys(("model",) + tuple(prev))))
        elif v == "seqpar":
            model.rules = model.rules.with_overrides(act_seq="model")
        elif v == "cponly":
            model.rules = model.rules.with_overrides(
                act_seq="model", q_heads=None, head_dim=None,
                kv_heads=None, mlp=None)
        elif v == "moedecode":
            model.rules = model.rules.with_overrides(
                expert_in=None, expert_d="data")
        elif v == "nofsdp":
            model.rules = model.rules.with_overrides(embed_fsdp=None)
        else:
            raise ValueError(f"unknown variant {v}")
    return microbatch


def _local_bytes(tree) -> int:
    """Rank 0's bytes of every tensor of a tree (a DTensor's shard)."""
    if isinstance(tree, dict):
        return sum(_local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_local_bytes(v) for v in tree)
    if not isinstance(tree, torch.Tensor):
        return 0
    t = tree.to_local() if hasattr(tree, "to_local") else tree
    return t.numel() * t.element_size()


def _fake_like(tree):
    """CPU tensors (fake, under ``FakeTensorMode``) of a tree of "meta"
    tensors' shapes and types."""
    if isinstance(tree, dict):
        return {k: _fake_like(v) for k, v in tree.items()}
    return torch.zeros(tree.shape, dtype=tree.dtype)


def _materialize(model: Transformer) -> None:
    """Every "meta" parameter as a (fake) CPU tensor of its shape."""
    for m in model.params.modules():
        for name, p in list(m._parameters.items()):
            m._parameters[name] = nn.Parameter(
                torch.empty(p.shape, dtype=p.dtype), requires_grad=False)


def _trace(model, cfg, shape, mesh, microbatch: int):
    """Place the step's arguments and trace it; returns (argument bytes,
    placement seconds, trace seconds, counter)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    rules = model.rules
    with FakeTensorMode():
        t0 = time.perf_counter()
        _materialize(model)
        model.shard(mesh)
        batch_sh = batch_shardings(cfg, shape, mesh, rules, model)
        batch = input_specs(cfg, shape, model, microbatch=microbatch)
        if shape.kind == "decode":
            batch["cache"] = distribute_tree(_fake_like(batch["cache"]),
                                             batch_sh["cache"])
            batch["token"] = batch_sh["token"].distribute(
                _fake_like(batch["token"]))
            batch["pos"] = None  # a Python int in the port (not an input)
            args = 4  # the reference's pos: one int32 scalar
        else:
            batch = distribute_tree(_fake_like(batch), batch_sh)
            args = 0
        state = None
        if shape.kind == "train":
            opt_cfg = OptimizerConfig(name=cfg.optimizer)
            init_fn, _ = make_optimizer(opt_cfg)
            state = distribute_tree(init_fn(param_leaves(model)),
                                    opt_state_shardings(
                                        cfg.optimizer, model.param_specs(),
                                        mesh, rules))
            step = make_train_step(model, opt_cfg, microbatch=microbatch)
        args += _local_bytes([p for p in model.params.parameters()]) \
            + _local_bytes(state) + _local_bytes(batch)
        t_place = time.perf_counter() - t0
        t0 = time.perf_counter()
        with StepCounter() as counter:
            if shape.kind == "train":
                step(state, batch)
            elif shape.kind == "prefill":
                model.prefill(**batch)
            else:
                cache_len, ring = serve_cache_len(cfg, shape)
                model.decode_step(batch["token"], batch["cache"],
                                  cache_len - 1, ring=ring)
        t_trace = time.perf_counter() - t0
    return args, t_place, t_trace, counter


def lower_cell(arch: str, shape_name: str, mesh_name: str,
               microbatch: int = 1, variants: tuple[str, ...] = (), *,
               cfg: ModelConfig | None = None,
               shape: ShapeConfig | None = None,
               mesh_shape: tuple | None = None) -> dict:
    """One cell's result dict (the reference's keys).  ``cfg``,
    ``shape`` and ``mesh_shape`` replace the arch's config, the shape's
    sizes and the production mesh's shape (same axis names) for a small
    cell."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    prod_shape, axes = production_shape(multi_pod=(mesh_name == "multi"))
    mesh_shape = tuple(mesh_shape or prod_shape)
    chips = math.prod(mesh_shape)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=chips)
    try:
        mesh = make_mesh_compat(mesh_shape, axes, device_type="cpu")
        model = Transformer(cfg, device="meta")
        adjust_rules_for_shape(model, shape, mesh)
        microbatch = apply_variants(model, variants, microbatch)
        args, t_place, t_trace, counter = _trace(model, cfg, shape, mesh,
                                                 microbatch)
    finally:
        dist.destroy_process_group()
    mem = {"argument_bytes": int(args), "output_bytes": 0,
           "temp_bytes": int(counter.peak), "alias_bytes": 0}
    rep = analyze_counts(counter, arch=arch, shape=shape_name,
                         mesh_name=mesh_name, chips=chips,
                         model_flops=model_flops(cfg, shape), memory=mem)
    out = rep.to_dict()
    out.update({
        "_migrated_global": True,  # metrics are global (x chips) already
        "lower_s": round(t_place, 2), "compile_s": round(t_trace, 2),
        "microbatch": microbatch,
        "fits_80g": mem["temp_bytes"] + mem["argument_bytes"] < HBM_BYTES,
        "params": int(cfg.n_params()),
        "active_params": int(cfg.n_active_params()),
    })
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--variants", default="",
                    help="comma list: mb8,ctxcache,seqpar")
    ap.add_argument("--out", default="results")
    args = ap.parse_args(argv)
    variants = tuple(v for v in args.variants.split(",") if v)

    os.makedirs(args.out, exist_ok=True)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = [(a, s) for a, s, skip in planned_cells() if not skip]
    else:
        assert args.arch and args.shape
        cells = [(args.arch, args.shape)]

    failures = 0
    for arch, shape in cells:
        for mesh_name in meshes:
            tag = f"{arch}__{shape}__{mesh_name}"
            path = os.path.join(args.out, tag + ".json")
            if os.path.exists(path):
                print(f"[skip cached] {tag}")
                continue
            print(f"[dryrun] {tag} ...", flush=True)
            try:
                res = lower_cell(arch, shape, mesh_name,
                                 microbatch=args.microbatch,
                                 variants=variants)
                with open(path, "w") as f:
                    json.dump(res, f, indent=1)
                print(f"  ok: trace={res['compile_s']}s "
                      f"flops={res['hlo_flops']:.3e} "
                      f"coll={res['coll_bytes']:.3e} "
                      f"bottleneck={res['bottleneck']} "
                      f"mem={res['memory_per_device']}", flush=True)
            except Exception as e:
                failures += 1
                with open(path + ".err", "w") as f:
                    f.write(traceback.format_exc())
                print(f"  FAILED: {type(e).__name__}: {e}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
