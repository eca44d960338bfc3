"""Logical-axis sharding: rules -> DTensor placements on a DeviceMesh (a
port of ``repro.models.sharding``).

Every parameter and activation dimension carries a *logical* axis name;
a rule table maps logical axes to mesh axes.  Rules adapt to the mesh in
use (single-pod ('data', 'model') or multi-pod ('pod', 'data',
'model')), and per-architecture overrides handle divisibility (gemma3's
4 heads cannot split 16 ways, so head_dim is sharded instead).

``ShardingRules.spec`` gives, per tensor dim, ``None``, a mesh-axis name
or a tuple of names: the entries of the reference's ``PartitionSpec``.
``NamedSharding`` turns such a spec into the placements of a
``torch.distributed.tensor.DTensor`` on a ``DeviceMesh`` (one per mesh
dim: ``Shard(d)`` where that mesh axis shards tensor dim ``d``, else
``Replicate()``).  ``constrain`` is the reference's
``with_sharding_constraint``: a redistribute of a DTensor, the identity
on a plain tensor (no mesh in use), with no ambient-mesh global.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import torch
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import implicit_replication

from ..kernels.sharded import is_dtensor


# Logical axes used across the stack:
#   batch, seq, embed, mlp, heads, kv_heads, head_dim, qkv, vocab,
#   experts, expert_in, expert_out, ssm_state, ssm_heads, conv, layers,
#   groups, stack
DEFAULT_RULES: dict[str, tuple[str, ...] | None] = {
    "batch": ("pod", "data"),
    "seq": None,
    "act_seq": None,  # residual-stream seq dim (seqpar variant -> model)
    "embed": None,
    "embed_fsdp": ("data",),  # FSDP weight shard of the d_model dim
    "mlp": ("model",),
    "q_heads": ("model",),  # resolved per-arch in Transformer.__init__
    "kv_heads": None,
    "head_dim": None,
    "vocab": ("model",),
    "experts": ("model",),
    "expert_in": ("data",),
    "expert_d": None,  # dispatch-buffer d_model dim (decode -> data)
    "expert_out": None,
    "ssm_state": None,
    "ssm_heads": ("model",),
    "conv": None,
    "layers": None,
    "groups": None,
    "stack": None,
    "cache_batch": ("pod", "data"),
    "cache_seq": None,
    "cache_heads": None,
    "cache_dim": ("model",),
}


@dataclass(frozen=True)
class ShardingRules:
    rules: dict = field(default_factory=lambda: dict(DEFAULT_RULES))

    def with_overrides(self, **kw) -> "ShardingRules":
        r = dict(self.rules)
        for k, v in kw.items():
            r[k] = tuple(v) if isinstance(v, (list, tuple)) else (
                None if v is None else (v,))
        return ShardingRules(r)

    def spec(self, axes: tuple[str | None, ...],
             mesh_axes: tuple[str, ...]) -> tuple:
        """Map logical axes -> one entry a tensor dim (None, a mesh axis
        or a tuple of them), dropping mesh axes that are not present in
        the mesh and de-duplicating mesh axes (first logical dim
        wins)."""
        used: set[str] = set()
        out = []
        for ax in axes:
            if ax is None:
                out.append(None)
                continue
            target = self.rules.get(ax)
            if target is None:
                out.append(None)
                continue
            picked = tuple(m for m in target if m in mesh_axes and
                           m not in used)
            used.update(picked)
            if len(picked) == 0:
                out.append(None)
            elif len(picked) == 1:
                out.append(picked[0])
            else:
                out.append(picked)
        return tuple(out)


def mesh_axes(mesh) -> tuple[str, ...]:
    """A DeviceMesh's axis names (the reference's ``mesh.axis_names``)."""
    return tuple(mesh.mesh_dim_names)


def placements_of(spec: tuple, names: tuple[str, ...]) -> tuple:
    """DTensor placements (one a mesh dim) of a spec: ``Shard(d)`` on the
    mesh dims that shard tensor dim ``d``, ``Replicate()`` elsewhere.  A
    dim sharded over several mesh axes takes ``Shard(d)`` on each, in
    mesh order: major to minor, as JAX splits ``("pod", "data")``."""
    dim_of = {}
    for d, entry in enumerate(spec):
        for m in (entry,) if isinstance(entry, str) else (entry or ()):
            dim_of[m] = d
    return tuple(Shard(dim_of[m]) if m in dim_of else Replicate()
                 for m in names)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the counterpart of ``jax.sharding.NamedSharding``."""
    mesh: object  # torch.distributed.device_mesh.DeviceMesh
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements_of(self.spec, mesh_axes(self.mesh))

    def distribute(self, t):
        """``t`` (the same full value on every rank) as a DTensor with
        this sharding: each rank keeps its own shard."""
        return distribute_tensor(torch.as_tensor(t), self.mesh,
                                 self.placements, src_data_rank=None)


def sharding_for(axes: tuple[str | None, ...], mesh,
                 rules: ShardingRules) -> NamedSharding:
    return NamedSharding(mesh, rules.spec(axes, mesh_axes(mesh)))


def constrain(x, axes: tuple[str | None, ...], rules: ShardingRules):
    """Redistribute a DTensor to the rules' placements for ``axes``
    (differentiable); a plain tensor is returned as it is."""
    if not is_dtensor(x):
        return x
    mesh = x.device_mesh
    placements = placements_of(rules.spec(axes, mesh_axes(mesh)),
                               mesh_axes(mesh))
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)


def replicate_plain_tensors():
    """A context in which plain tensors meeting DTensors are taken as
    replicated on the mesh (the global values an entry point makes:
    positions, masks, buffers).  Nested uses leave it on until the
    outermost ends (``implicit_replication`` alone turns it off at the
    first exit)."""
    if DTensor._op_dispatcher._allow_implicit_replication:
        return contextlib.nullcontext()
    return implicit_replication()
