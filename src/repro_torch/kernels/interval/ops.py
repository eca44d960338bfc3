"""Wrapper of the interval point-stab kernel (``csrc/interval_sm90.cu``).

Replaces ``src/repro/kernels/interval/kernel.py::interval_query_pallas``.
A CPU tensor takes the plain version; a CUDA tensor launches
``interval_sm90`` (a thread a query over a shared-memory directory of
``lo``), one launch over the whole level, or raises.
"""

from __future__ import annotations

import torch

from ...obs import span
from .. import native
from .ref import interval_query_ref


def interval_query(keys32, seqs32, lo, hi, smin, smax) -> torch.Tensor:
    """int32 {0,1} (n,): is (key, seq) covered by the disjoint level?"""
    with span("kernel.interval", n=int(keys32.numel()),
              areas=int(lo.numel())):
        if keys32.device.type == "cpu":
            return interval_query_ref(keys32, seqs32, lo, hi, smin, smax)
        return _launch_sm90(keys32, seqs32, lo, hi, smin, smax)


def _launch_sm90(keys32, seqs32, lo, hi, smin, smax, *,
                 planted_fault: bool = False):
    """``interval_sm90``; ``planted_fault`` searches lower_bound (a wrong
    kernel, for the card's checks)."""
    n, m = keys32.numel(), lo.numel()
    if seqs32.numel() != n or not hi.numel() == smin.numel() \
            == smax.numel() == m or m >= 1 << 31:
        raise ValueError(f"interval_sm90: {n} keys with {seqs32.numel()} "
                         f"seqs, columns of {m}, {hi.numel()}, "
                         f"{smin.numel()}, {smax.numel()} areas")
    dev = native.require_cuda("interval_sm90", keys32, seqs32, lo, hi,
                              smin, smax)
    out = torch.empty(n, dtype=torch.int32, device=dev)
    p = native.ptr
    fn = native.entry("interval_sm90", "interval_sm90_launch")
    native.check("interval_sm90", fn(
        n, p(keys32), p(seqs32), m, p(lo), p(hi), p(smin), p(smax), p(out),
        int(planted_fault), native.stream(dev)))
    native.count_launch("interval_sm90")
    return out


def _launch_floor(n: int, device) -> None:
    """An empty kernel on ``interval_sm90``'s grid for n queries: the
    launch floor beneath its time (not a launch of the stab)."""
    dev = torch.device(device)
    fn = native.entry("interval_sm90", "interval_sm90_floor_launch")
    native.check("interval_sm90_floor", fn(n, native.stream(dev)))
