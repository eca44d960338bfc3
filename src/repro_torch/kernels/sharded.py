"""A function on the local shards of DTensor operands.

The model kernels compute every (batch, head) cell on its own, so a
DTensor whose batch or heads are sharded over a mesh can run the kernel
on each rank's shard.  ``local_apply`` brings the operands to such a
layout (``plan``) and calls the function on the local shards through
``torch.distributed.tensor.experimental.local_map``.  ``plan``
redistributes every other dim to ``Replicate()`` (sequence, head_dim,
chunk, state: the kernels do not split them), gives every operand the
batch sharding of the first (the lead), and lets an operand whose heads
are grouped (GQA's K/V) keep its heads sharded only where they line up
with the lead's; elsewhere it is replicated and each rank selects the
heads its lead heads read.  Autograd runs the backward on the local
shards too: the selection is an ``index_select``, and the gradient of a
replicated operand read in part on each rank is ``Partial()`` over that
mesh dim (``local_map``'s ``in_grad_placements``).  ``local_map`` wraps
the outputs as even shards, so ``plan`` refuses a dim that does not
split evenly.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


@dataclass(frozen=True)
class Role:
    """An operand's dims: ``batch`` and ``heads`` (None: it has none);
    ``group`` heads of the lead operand read one of its heads."""
    batch: int | None = 0
    heads: int | None = None
    group: int = 1


def _redistribute(t, placements):
    placements = tuple(placements)
    if tuple(t.placements) == placements:
        return t
    return t.redistribute(t.device_mesh, placements)


def _head_range(t, dim: int) -> tuple[int, int]:
    """(offset, size) of this rank's shard of dim ``dim`` of a DTensor:
    each mesh dim that shards it splits the rest as ``torch.chunk``
    does, in mesh order (computed on the host: under ``FakeTensorMode``
    DTensor's own helper would need data)."""
    start, size = 0, t.shape[dim]
    coord = t.device_mesh.get_coordinate()
    for i, p in enumerate(t.placements):
        if isinstance(p, Shard) and p.dim == dim:
            per = -(-size // t.device_mesh.size(i))
            lo = min(coord[i] * per, size)
            start, size = start + lo, min(lo + per, size) - lo
    return start, size


def _check_even(t):
    for i, p in enumerate(t.placements):
        if isinstance(p, Shard) and t.shape[p.dim] % t.device_mesh.size(i):
            raise ValueError(f"dim {p.dim} of {tuple(t.shape)} does not "
                             f"split evenly over mesh dim {i}")


def plan(tensors, roles):
    """(the operands redistributed, their gradients' placements, each
    operand's head selection: None or (dim, index)) for a function whose
    first operand (the lead) sets the layout; ``roles`` gives each
    operand's dims.  Differentiable: the redistributions are autograd
    ops."""
    lead, lrole = tensors[0], roles[0]
    mesh = lead.device_mesh
    keep = {lrole.batch, lrole.heads}
    head = None if lrole.heads is None else Shard(lrole.heads)
    dpl = tuple(p if isinstance(p, Shard) and p.dim in keep
                else Replicate() for p in lead.placements)
    out_t, grads, select = [_redistribute(lead, dpl)], [dpl], [None]
    for t, role in zip(tensors[1:], roles[1:]):
        pl, gpl = [], []
        for i, dp in enumerate(dpl):
            n = mesh.size(i)
            if dp == Shard(lrole.batch):
                # An operand without a batch dim is read whole.
                shard = Replicate() if role.batch is None \
                    else Shard(role.batch)
                pl.append(shard)
                gpl.append(Partial() if role.batch is None else shard)
            elif dp == head and role.heads is not None and (
                    role.group == 1 or (
                        t.placements[i] == Shard(role.heads)
                        and lead.shape[lrole.heads] % n == 0
                        and t.shape[role.heads] % n == 0)):
                pl.append(Shard(role.heads))
                gpl.append(Shard(role.heads))
            else:
                pl.append(Replicate())
                gpl.append(Partial() if dp == head else Replicate())
        t = _redistribute(t, pl)
        sel = None
        if role.heads is not None and role.group > 1:
            q0, qn = _head_range(out_t[0], lrole.heads)
            k0, kn = _head_range(t, role.heads)
            if not (q0 == k0 * role.group and qn == kn * role.group):
                idx = torch.arange(q0, q0 + qn) // role.group
                if q0 % role.group == 0 and qn % role.group == 0:
                    idx = idx[::role.group]  # whole groups: their heads
                sel = (role.heads, idx - k0)
        out_t.append(t)
        grads.append(tuple(gpl))
        select.append(sel)
    for t in out_t:
        _check_even(t)
    return out_t, grads, select


def local_apply(fn, tensors, roles, out_roles):
    """``fn(*tensors)`` for DTensor operands computed on each rank's local
    shards in ``plan``'s layout: a tuple of DTensors, placed by the lead
    operand's batch and head sharding at the dims ``out_roles`` name;
    differentiable.  For a function that, like the model kernels,
    treats every (batch, head) cell on its own."""
    tensors, grads, select = plan(tensors, roles)
    lead, lrole = tensors[0], roles[0]

    def placed(role: Role) -> tuple:
        move = {Shard(lrole.batch): Shard(role.batch)}
        if lrole.heads is not None:
            move[Shard(lrole.heads)] = Shard(role.heads)
        return tuple(move.get(p, p) for p in lead.placements)

    def local(*ts):
        ts = [t if s is None else t.index_select(s[0], s[1].to(t.device))
              for t, s in zip(ts, select)]
        out = fn(*(t.contiguous() for t in ts))
        return tuple(o.contiguous() for o in (
            out if isinstance(out, tuple) else (out,)))

    return local_map(local, tuple(placed(r) for r in out_roles),
                     in_grad_placements=tuple(grads),
                     device_mesh=lead.device_mesh)(*tensors)
