"""Step factories: train_step / prefill_step / decode_step + input_specs
(a port of ``repro.launch.steps``).

``input_specs`` gives every model input as a tensor on the "meta"
device: shape and type, no memory; ``batch_shardings`` and
``opt_state_shardings`` give the matching ``NamedSharding`` trees on a
DeviceMesh (``distribute_tree`` places a tree by them), and
``adjust_rules_for_shape`` fits a model's rules to a (shape x mesh).
The steps run on plain tensors or, with ``model.shard(mesh)``, on
DTensors: the train step then reduces its gradient norm over the whole
mesh and returns its metrics as plain tensors.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import Replicate

from ..carry import param_leaves
from ..configs.base import ModelConfig, ShapeConfig
from ..models import Transformer
from ..models.layers import cross_entropy_loss
from ..models.params import ParamSpec, is_spec, tree_map
from ..models.sharding import (NamedSharding, ShardingRules, is_dtensor,
                               mesh_axes)
from ..optim.optimizer import OptimizerConfig, make_optimizer


# --------------------------------------------------------------- geometry
def serve_cache_len(cfg: ModelConfig, shape: ShapeConfig) -> tuple[int, bool]:
    """(cache_len, ring): SWA archs decode against a ring buffer of the
    window; hybrids switch their shared attention to a 4096 ring for
    long_500k."""
    if cfg.family == "hybrid":
        if shape.name == "long_500k":
            return 4096, True
        return shape.seq_len, False
    if cfg.window is not None and cfg.local_global is None:
        return min(cfg.window, shape.seq_len), True
    return shape.seq_len, False


def adjust_rules_for_shape(model: Transformer, shape: ShapeConfig,
                           mesh) -> None:
    """Divisibility-aware rule adjustment for a concrete (shape x mesh).

    long_500k has global_batch=1: batch can't shard over ('pod','data').
    Fall back to replicated batch and recover parallelism from the cache
    sequence dim (context-parallel decode); 'data' is otherwise idle in
    a batch-1 decode."""
    sizes = dict(zip(mesh_axes(mesh), mesh.shape))
    batch_axes = model.rules.rules.get("batch") or ()
    shards = 1
    for a in batch_axes:
        shards *= sizes.get(a, 1)
    if shards > 1 and shape.global_batch % shards != 0:
        cache_seq = model.rules.rules.get("cache_seq") or ()
        new_seq = tuple(a for a in ("data",) + tuple(cache_seq)
                        if a in sizes)
        model.rules = model.rules.with_overrides(
            batch=None, cache_batch=None, cache_seq=new_seq or None)


# ------------------------------------------------------------ input specs
def input_specs(cfg: ModelConfig, shape: ShapeConfig, model: Transformer,
                microbatch: int = 1) -> dict:
    """"meta" tensors standing in for every input of a step
    (``microbatch`` splits the train batch inside the step: the inputs
    are the same)."""
    b, s = shape.global_batch, shape.seq_len

    def spec(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    dt, i32 = model.dtype, torch.int32
    if shape.kind in ("train", "prefill"):
        if cfg.stub_frontend is not None:
            data = {"embeds": spec((b, s, cfg.d_model), dt)}
        else:
            data = {"tokens": spec((b, s), i32)}
        if shape.kind == "train":
            data["labels"] = spec((b, s), i32)
        return data
    # decode: one new token against a seq_len cache.
    cache_len, _ = serve_cache_len(cfg, shape)
    if cfg.stub_frontend is not None:
        tok = spec((b, 1, cfg.d_model), dt)
    else:
        tok = spec((b, 1), i32)
    return {"token": tok, "cache": model.init_cache(b, cache_len,
                                                     device="meta"),
            "pos": spec((), i32)}


def batch_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh,
                    rules: ShardingRules, model: Transformer):
    """NamedShardings matching input_specs."""
    ax = mesh_axes(mesh)
    bspec = NamedSharding(mesh, rules.spec(("batch", None), ax))
    bspec3 = NamedSharding(mesh, rules.spec(("batch", None, "embed"), ax))
    key, tok = ("embeds", bspec3) if cfg.stub_frontend is not None \
        else ("tokens", bspec)
    if shape.kind == "train":
        return {"labels": bspec, key: tok}
    if shape.kind == "prefill":
        return {key: tok}
    cache_sh = {k: NamedSharding(mesh, rules.spec(axes, ax))
                for k, axes in model.cache_logical_axes().items()}
    return {"token": tok, "cache": cache_sh,
            "pos": NamedSharding(mesh, ())}


def opt_state_shardings(opt_name: str, specs, mesh, rules: ShardingRules):
    """Optimizer state shards like its parameter (reduced dims dropped);
    ``specs`` is the stacked spec tree (``model.param_specs()``)."""
    ax = mesh_axes(mesh)
    scalar = NamedSharding(mesh, ())
    if opt_name == "adamw":
        like_param = tree_map(
            lambda s: NamedSharding(mesh, rules.spec(s.axes, ax)), specs)
        return {"mu": like_param, "nu": like_param, "step": scalar}

    def factored(s: ParamSpec):
        if len(s.shape) >= 2:
            return {"vr": NamedSharding(mesh, rules.spec(s.axes[:-1], ax)),
                    "vc": NamedSharding(
                        mesh, rules.spec(s.axes[:-2] + s.axes[-1:], ax))}
        return {"v": NamedSharding(mesh, rules.spec(s.axes, ax))}

    return {"f": tree_map(factored, specs, is_leaf=is_spec),
            "step": scalar}


def _full(t):
    """A DTensor metric as the plain tensor of its value."""
    return t.full_tensor() if is_dtensor(t) else t


# ------------------------------------------------------------------ steps
def make_train_step(model: Transformer, opt_cfg: OptimizerConfig,
                    microbatch: int = 1, aux_loss_weight: float = 0.01):
    """Returns train_step(opt_state, batch) -> (opt_state, metrics); the
    step updates the model's parameters in place.  ``microbatch > 1``
    splits the batch into that many sequential microbatches and
    accumulates their gradients in f32 (the reference's ``lax.scan``):
    one optimizer update a step.  ``aux_loss_weight`` is accepted and
    unused, as in the reference, which adds no MoE auxiliary loss."""
    _, update_fn = make_optimizer(opt_cfg)
    leaves = param_leaves(model.trainable(True))
    params = [p for leaf in leaves for p in leaf.parts]

    def loss_fn(data):
        kw = {"tokens": data["tokens"]} if "tokens" in data \
            else {"embeds": data["embeds"]}
        logits = model.forward_train(**kw)
        return cross_entropy_loss(logits, torch.as_tensor(
            data["labels"], device=logits.device))

    def value_and_grad(data):
        """The loss; every parameter's gradient (zeros where none
        reached it, as autodiff gives) in its ``.grad``."""
        for p in params:
            p.grad = None
        with model._mesh_context():
            loss = loss_fn(data)
            if is_dtensor(loss):  # a Partial mean: backward from its sum
                loss = loss.redistribute(loss.device_mesh, [
                    Replicate()] * loss.device_mesh.ndim)
            loss.backward()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return loss.detach()

    def train_step(opt_state, batch):
        if microbatch > 1:
            gsum = [torch.zeros_like(p, dtype=torch.float32)
                    for p in params]
            lsum = 0.0
            for i in range(microbatch):
                data = {k: v[i * len(v) // microbatch:
                             (i + 1) * len(v) // microbatch]
                        for k, v in batch.items()}
                lsum = lsum + value_and_grad(data)
                for buf, p in zip(gsum, params):
                    buf.add_(p.grad)
                    p.grad = None
            flat = [g.div_(microbatch) for g in gsum]
            loss = lsum / microbatch
        else:
            loss = value_and_grad(batch)
            flat = [p.grad for p in params]
        it = iter(flat)
        grads = [[next(it) for _ in leaf.parts] for leaf in leaves]
        with model._mesh_context():
            opt_state, info = update_fn(leaves, grads, opt_state)
        for p in params:
            p.grad = None
        metrics = {"loss": loss, **info}
        return opt_state, {k: _full(v) for k, v in metrics.items()}

    return train_step


def make_prefill_step(model: Transformer):
    def prefill_step(batch):
        return model.prefill(**batch)

    return prefill_step


def make_decode_step(model: Transformer, ring: bool = False):
    def decode_step(token, cache, pos):
        return model.decode_step(token, cache, pos, ring=ring)

    return decode_step
