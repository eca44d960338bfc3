"""Step factories: train_step / prefill_step / decode_step + input_specs
(a port of ``repro.launch.steps``).

``input_specs`` gives every model input as a tensor on the "meta"
device: shape and type, no memory.  The reference's sharding helpers
(``adjust_rules_for_shape``, ``batch_shardings``,
``opt_state_shardings``) need a mesh and wait for the multi-card slice.
"""

from __future__ import annotations

import torch

from ..carry import param_leaves
from ..configs.base import ModelConfig, ShapeConfig
from ..models import Transformer
from ..models.layers import cross_entropy_loss
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


# ------------------------------------------------------------ input specs
def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                model: Transformer) -> dict:
    """"meta" tensors standing in for every input of a step."""
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
        loss = loss_fn(data)
        loss.backward()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return loss.detach()

    def train_step(opt_state, batch):
        if microbatch > 1:
            gsum = [torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device) for p in params]
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
        opt_state, info = update_fn(leaves, grads, opt_state)
        for p in params:
            p.grad = None
        return opt_state, {"loss": loss, **info}

    return train_step


def make_prefill_step(model: Transformer):
    def prefill_step(batch):
        return model.prefill(**batch)

    return prefill_step


def make_decode_step(model: Transformer, ring: bool = False):
    def decode_step(token, cache, pos):
        return model.decode_step(token, cache, pos, ring=ring)

    return decode_step
