"""Optimizers: AdamW and Adafactor (factored second moments), as
functions on tensors (a port of ``repro.optim.optimizer``).

Parameters come as ``carry.Leaf``s: one leaf a tree path of the JAX
package's param tree, holding the port's per-layer tensors of that
path (``layers/...`` (L, ...), ``groups/mamba/...`` (G, per, ...),
``tail/mamba/...`` (T, ...)).  Optimizer state lies in the JAX
package's layout: a tree keyed like its params, each leaf one f32
tensor of the stacked shape, so checkpoints of either package restore
in the other.  Updates write the parameters in place, in f32 with one
cast back to the parameter's type, as the reference computes them.

AdamW is elementwise: it goes a layer view of the state at a time, and
never makes a stacked copy of a leaf (``groups/mamba/w_in`` of
zamba2-7b is gigabytes in f32).  Adafactor factors, and clips its
update by, statistics of the whole stacked leaf (a (G, per, d) norm
weight is factored across layers), so it stacks one leaf at a time in
f32; it is the optimizer of kimi-k2, whose 1 T parameters no one card
holds.  ``torch.optim`` is not used: its arithmetic is not the
reference's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial

import torch

from ..carry import nest


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"  # adamw | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1


def lr_schedule(cfg: OptimizerConfig, step):
    """Linear warmup + cosine decay to min_lr_ratio; ``step`` an int
    tensor, the result an f32 tensor."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp((step + 1) / max(1, cfg.warmup_steps), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) /
                       max(1, cfg.decay_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(grads):
    """sqrt of the sum of squares of every tensor (f32); ``grads`` is a
    list of leaves, each a list of tensors."""
    total = sum(torch.sum(torch.square(g.float()))
                for parts in grads for g in parts)
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def clip_by_global_norm(grads, max_norm):
    """(the f32 scale that brings the global norm to at most
    ``max_norm``, the norm); the caller multiplies each gradient by the
    scale as it reads it, so no clipped copy is kept."""
    norm = global_norm(grads)
    return torch.clamp(max_norm / (norm + 1e-9), max=1.0), norm


def _rows(t: torch.Tensor, lead: tuple) -> torch.Tensor:
    """A stacked state tensor as (layers, ...): row i is the state of a
    leaf's part i (a view)."""
    return t.reshape((math.prod(lead),) + tuple(t.shape[len(lead):]))


def _get(tree: dict, path: str):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _zeros(shape, leaf):
    return torch.zeros(shape, dtype=torch.float32,
                       device=leaf.parts[0].device)


# ------------------------------------------------------------------ AdamW
def adamw_init(leaves) -> dict:
    zeros = lambda: nest({leaf.path: _zeros(leaf.shape, leaf)
                          for leaf in leaves})
    return {"mu": zeros(), "nu": zeros(),
            "step": torch.zeros((), dtype=torch.int32,
                                device=leaves[0].parts[0].device)}


@torch.no_grad()
def adamw_update(cfg: OptimizerConfig, leaves, grads, state) -> tuple:
    """One step: writes every parameter and the state in place; returns
    (state, {"lr", "grad_norm"})."""
    step = state["step"] + 1
    lr = lr_schedule(cfg, step)
    scale, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    b1, b2 = cfg.b1, cfg.b2
    c1 = 1 - b1 ** step.float()
    c2 = 1 - b2 ** step.float()
    for leaf, gparts in zip(leaves, grads):
        mus = _rows(_get(state["mu"], leaf.path), leaf.lead)
        nus = _rows(_get(state["nu"], leaf.path), leaf.lead)
        for i, (p, g) in enumerate(zip(leaf.parts, gparts)):
            g = g.float() * scale
            mu = mus[i].mul_(b1).add_((1 - b1) * g)
            nu = nus[i].mul_(b2).add_((1 - b2) * g * g)
            p32 = p.float()
            delta = (mu / c1) / (torch.sqrt(nu / c2) + cfg.eps) + \
                cfg.weight_decay * p32
            p.copy_(p32 - lr * delta)
    state["step"] = step
    return state, {"lr": lr, "grad_norm": gnorm}


# -------------------------------------------------------------- Adafactor
def adafactor_init(leaves) -> dict:
    def st(leaf):
        shape = leaf.shape
        if len(shape) >= 2:
            # factor the two largest (trailing) dims; leading dims (layer
            # stacks) are batched.
            return {"vr": _zeros(shape[:-1], leaf),
                    "vc": _zeros(shape[:-2] + shape[-1:], leaf)}
        return {"v": _zeros(shape, leaf)}

    return {"f": nest({leaf.path: st(leaf) for leaf in leaves}),
            "step": torch.zeros((), dtype=torch.int32,
                                device=leaves[0].parts[0].device)}


@torch.no_grad()
def adafactor_update(cfg: OptimizerConfig, leaves, grads, state) -> tuple:
    step = state["step"] + 1
    lr = lr_schedule(cfg, step)
    scale, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    decay = 1.0 - (step.float() + 1.0) ** -0.8
    for leaf, gparts in zip(leaves, grads):
        f = _get(state["f"], leaf.path)
        g = torch.stack([x.float() for x in gparts]).reshape(leaf.shape) \
            * scale
        g2 = g * g + 1e-30
        if g.ndim >= 2:
            f["vr"].mul_(decay).add_((1 - decay) * g2.mean(dim=-1))
            f["vc"].mul_(decay).add_((1 - decay) * g2.mean(dim=-2))
            denom = f["vr"].mean(dim=-1, keepdim=True)
            v = (f["vr"][..., None] * f["vc"][..., None, :]) / \
                torch.clamp(denom[..., None], min=1e-30)
        else:
            v = f["v"].mul_(decay).add_((1 - decay) * g2)
        update = g / torch.sqrt(v + 1e-30)
        # Update clipping (RMS <= 1) as in the paper.
        rms = torch.sqrt(torch.mean(update * update) + 1e-30)
        update = update / torch.clamp(rms, min=1.0)
        update = update.reshape((len(leaf.parts),) + leaf.part_shape)
        for p, u in zip(leaf.parts, update):
            p32 = p.float()
            p.copy_(p32 - lr * (u + cfg.weight_decay * p32))
    state["step"] = step
    return state, {"lr": lr, "grad_norm": gnorm}


def make_optimizer(cfg: OptimizerConfig):
    if cfg.name == "adamw":
        return adamw_init, partial(adamw_update, cfg)
    if cfg.name == "adafactor":
        return adafactor_init, partial(adafactor_update, cfg)
    raise ValueError(cfg.name)
