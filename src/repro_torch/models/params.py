"""Parameter specs: shapes, logical axes and init rules.

The model is described by a nested structure (dicts and lists) of
``ParamSpec``; ``init_params`` materializes it as tensors on one device,
drawing from an explicit ``torch.Generator``.  The init rules are the
JAX package's (``normal``, ``ones``, ``zeros``, ``a_log``, ``dt_bias``);
the random numbers differ, since the two frameworks' generators do.
From the logical axes ``tree_abstract`` derives "meta" tensors (the
dry-run's allocation-free stand-ins) and ``tree_shardings`` the
``NamedSharding`` of every leaf on a mesh, which ``distribute_tree``
applies as ``jax.device_put(tree, shardings)`` does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .sharding import NamedSharding, ShardingRules, sharding_for


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    axes: tuple  # logical axis names, len == len(shape)
    init: str = "normal"  # normal | ones | zeros | a_log | dt_bias
    scale: float = 0.02

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def spec_leaves(specs) -> list[ParamSpec]:
    """The specs of a nested dict/list structure, in traversal order."""
    if isinstance(specs, ParamSpec):
        return [specs]
    items = specs.values() if isinstance(specs, dict) else specs
    return [leaf for s in items for leaf in spec_leaves(s)]


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def tree_map(fn, tree, is_leaf=is_spec):
    """``fn`` on every leaf of a nested dict/list structure (a leaf is
    what ``is_leaf`` accepts, or anything not a dict or list)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, is_leaf) for k, v in tree.items()}
    if isinstance(tree, list) and not is_leaf(tree):
        return [tree_map(fn, v, is_leaf) for v in tree]
    return fn(tree)


def tree_abstract(specs, dtype) -> dict:
    """"meta" tensors of the specs' shapes in ``dtype``: no memory."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=dtype,
                                          device="meta"), specs)


def tree_shardings(specs, mesh, rules: ShardingRules):
    """The ``NamedSharding`` of every spec's logical axes on ``mesh``."""
    return tree_map(lambda s: sharding_for(s.axes, mesh, rules), specs)


def distribute_tree(tree, shardings):
    """Every tensor of ``tree`` as a DTensor with the sharding at the
    same place in ``shardings`` (a tree of ``NamedSharding``)."""
    if isinstance(shardings, NamedSharding):
        return shardings.distribute(tree)
    if isinstance(tree, dict):
        return {k: distribute_tree(v, shardings[k]) for k, v in tree.items()}
    return [distribute_tree(v, s) for v, s in zip(tree, shardings)]


def count_params(specs) -> int:
    return int(sum(math.prod(s.shape) for s in spec_leaves(specs)))


def init_tensor(spec: ParamSpec, generator: torch.Generator, dtype,
                device) -> torch.Tensor:
    """One parameter drawn by ``spec.init`` in f32, cast to ``dtype``.
    The draw happens on the generator's device."""
    gdev = generator.device
    f32 = torch.float32
    if spec.init == "normal":
        x = torch.randn(spec.shape, generator=generator, dtype=f32,
                        device=gdev) * spec.scale
    elif spec.init == "ones":
        x = torch.ones(spec.shape, dtype=f32, device=gdev)
    elif spec.init == "zeros":
        x = torch.zeros(spec.shape, dtype=f32, device=gdev)
    elif spec.init == "a_log":  # mamba2: A in -[1, 16], stored as log
        u = torch.rand(spec.shape, generator=generator, dtype=f32,
                       device=gdev) * 15.0 + 1.0
        x = torch.log(u)
    elif spec.init == "dt_bias":  # softplus^-1 of dt in [1e-3, 1e-1]
        u = torch.rand(spec.shape, generator=generator, dtype=f32,
                       device=gdev) * (1e-1 - 1e-3) + 1e-3
        x = u + torch.log(-torch.expm1(-u))
    else:
        raise ValueError(spec.init)
    return x.to(device=device, dtype=dtype)


def init_params(specs, generator: torch.Generator, dtype, device):
    """Tensors of the same nested structure as ``specs``."""
    if isinstance(specs, ParamSpec):
        return init_tensor(specs, generator, dtype, device)
    if isinstance(specs, dict):
        return {k: init_params(v, generator, dtype, device)
                for k, v in specs.items()}
    return [init_params(v, generator, dtype, device) for v in specs]

