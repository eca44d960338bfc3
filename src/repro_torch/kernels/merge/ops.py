"""Wrappers of the merge kernels (``csrc/merge_path_sm90.cu`` and
``csrc/merge_rank.cu``).

Replace ``src/repro/kernels/merge/kernel.py::merge_rank_pallas`` and
the two calls of it in the JAX package's ``merge_ranks``.  A CPU tensor
takes the plain version; a CUDA tensor launches a kernel or raises.
``merge_positions`` places both runs of a two-way merge round in one
``merge_path_sm90`` launch; ``merge_rank`` ranks unsorted queries in
one sorted run (``merge_rank``, one thread a query).
"""

from __future__ import annotations

import numpy as np
import torch

from ...obs import span
from .. import native
from ..u32 import to_device, to_numpy
from .ref import merge_positions_ref, merge_rank_ref


def merge_rank(q: torch.Tensor, run: torch.Tensor, *,
               leq: bool) -> torch.Tensor:
    """int32 (n,) ranks of u32 queries in a sorted u32 run (searchsorted
    left for ``leq=False``, right for ``leq=True``)."""
    if q.device.type == "cpu":
        return merge_rank_ref(q, run, leq=leq)
    return _launch_rank(q, run, leq)


def _launch_rank(q, run, leq) -> torch.Tensor:
    dev = native.require_cuda("merge_rank", q, run)
    n = q.numel()
    out = torch.empty(n, dtype=torch.int32, device=dev)
    fn = native.entry("merge_rank", "merge_rank_launch")
    err = fn(n, native.ptr(q), run.numel(), native.ptr(run), int(leq),
             native.ptr(out), native.stream(dev))
    native.check("merge_rank", err)
    native.count_launch("merge_rank")
    return out


def merge_positions(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int32 (na + nb,) merged-output slots of two sorted u32 runs: a's
    first, then b's; ties across runs place a-entries first."""
    if a.device.type == "cpu":
        return merge_positions_ref(a, b)
    return _launch_merge_path(a, b)


def _launch_merge_path(a, b, *, planted_fault: bool = False):
    """``merge_path_sm90``; ``planted_fault`` breaks ties b-first (a
    wrong kernel, for the card's checks).  Two empty runs launch
    nothing."""
    dev = native.require_cuda("merge_path_sm90", a, b)
    out = torch.empty(a.numel() + b.numel(), dtype=torch.int32, device=dev)
    if not out.numel():
        return out
    fn = native.entry("merge_path_sm90", "merge_path_sm90_launch")
    err = fn(native.ptr(a), a.numel(), native.ptr(b), b.numel(),
             native.ptr(out), int(planted_fault), native.stream(dev))
    native.check("merge_path_sm90", err)
    native.count_launch("merge_path_sm90")
    return out


def _launch_floor(na: int, nb: int, device) -> None:
    """An empty kernel on ``merge_path_sm90``'s grid for runs of na and
    nb: the launch floor beneath its time (not a launch of the merge)."""
    dev = torch.device(device)
    fn = native.entry("merge_path_sm90", "merge_path_sm90_floor_launch")
    native.check("merge_path_sm90_floor", fn(na, nb, native.stream(dev)))


def merge_ranks(ka: np.ndarray, kb: np.ndarray, device):
    """Merged-output positions of two key-sorted u32 runs on ``device``.

    Returns ``(pa, pb)`` int64 numpy arrays: ``pa[i]`` is the slot of
    ``ka[i]`` in the merged order, ``pb`` likewise; ties across runs
    place a-entries first — bit-exact with the host searchsorted pair in
    ``lsm.merge.merge_two``.  One launch and one copy back."""
    with span("kernel.merge", n=len(ka) + len(kb)):
        out = to_numpy(merge_positions(to_device(ka, device),
                                       to_device(kb, device)), np.int32)
    pos = out.astype(np.int64)
    return pos[:len(ka)], pos[len(ka):]
