"""Plain PyTorch version of the interval point-stab kernel."""

from __future__ import annotations

import torch

from ..u32 import widen


def interval_query_ref(keys32, seqs32, lo, hi, smin, smax) -> torch.Tensor:
    """keys/seqs (n,) and level columns (A,) u32 in int32 storage, the
    level sorted by lo and key-disjoint.  Returns int32 {0,1} (n,)."""
    k, s = widen(keys32), widen(seqs32)
    lo, hi, smin, smax = (widen(t) for t in (lo, hi, smin, smax))
    if lo.numel() == 0:
        return torch.zeros(k.shape, dtype=torch.int32, device=k.device)
    idx = torch.searchsorted(lo, k, right=True) - 1
    ic = idx.clamp_min(0)
    cov = (idx >= 0) & (k < hi[ic]) & (smin[ic] <= s) & (s < smax[ic])
    return cov.to(torch.int32)
