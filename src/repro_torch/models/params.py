"""Parameter specs: shapes, logical axes and init rules.

The model is described by a nested structure (dicts and lists) of
``ParamSpec``; ``init_params`` materializes it as tensors on one device,
drawing from an explicit ``torch.Generator``.  The init rules are the
JAX package's (``normal``, ``ones``, ``zeros``, ``a_log``, ``dt_bias``);
the random numbers differ, since the two frameworks' generators do.
The logical axes are kept for the multi-GPU sharding still to come.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


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

