"""Wrapper of the merge-rank kernel (``csrc/merge_rank.cu``).

Replaces ``src/repro/kernels/merge/kernel.py::merge_rank_pallas``.  A
CPU tensor takes the plain version; a CUDA tensor launches the kernel,
one launch over the whole run, or raises.  ``merge_ranks`` turns two
ranks into a two-way merge round's output positions.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...obs import span
from .. import native
from ..u32 import to_device, to_numpy
from .ref import merge_rank_ref


def merge_rank(q: torch.Tensor, run: torch.Tensor, *,
               leq: bool) -> torch.Tensor:
    """int32 (n,) ranks of u32 queries in a sorted u32 run (searchsorted
    left for ``leq=False``, right for ``leq=True``)."""
    if q.device.type == "cpu":
        return merge_rank_ref(q, run, leq=leq)
    return _launch(q, run, leq)


def _launch(q, run, leq) -> torch.Tensor:
    dev = native.require_cuda("merge_rank", q, run)
    n = q.numel()
    out = torch.empty(n, dtype=torch.int32, device=dev)
    fn = native.library("merge_rank").merge_rank_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(n, native.ptr(q), run.numel(), native.ptr(run), int(leq),
             native.ptr(out), native.stream(dev))
    native.check("merge_rank", err)
    native.count_launch("merge_rank")
    return out


def merge_ranks(ka: np.ndarray, kb: np.ndarray, device):
    """Merged-output positions of two key-sorted u32 runs on ``device``.

    Returns ``(pa, pb)`` int64 numpy arrays: ``pa[i]`` is the slot of
    ``ka[i]`` in the merged order, ``pb`` likewise; ties across runs
    place a-entries first — bit-exact with the host searchsorted pair in
    ``lsm.merge.merge_two``."""
    with span("kernel.merge", n=len(ka) + len(kb)):
        a = to_device(ka, device)
        b = to_device(kb, device)
        ra = to_numpy(merge_rank(a, b, leq=False), np.int32)
        rb = to_numpy(merge_rank(b, a, leq=True), np.int32)
    return (np.arange(len(ka), dtype=np.int64) + ra,
            np.arange(len(kb), dtype=np.int64) + rb)
