"""Plain PyTorch versions of the merge kernels."""

from __future__ import annotations

import torch

from ..u32 import widen


def merge_rank_ref(q: torch.Tensor, run: torch.Tensor, *,
                   leq: bool) -> torch.Tensor:
    """Per query, the count of ``run`` elements below it (``leq=False``)
    or at-or-below it (``leq=True``); u32 in int32 storage -> int32."""
    return torch.searchsorted(widen(run), widen(q),
                              right=leq).to(torch.int32)


def merge_positions_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Merged-output slots of two sorted u32 runs: int32 (na + nb,), a's
    slots first, then b's; ties across runs place a-entries first."""
    pa = torch.arange(a.numel(), dtype=torch.int32, device=a.device) \
        + merge_rank_ref(a, b, leq=False)
    pb = torch.arange(b.numel(), dtype=torch.int32, device=b.device) \
        + merge_rank_ref(b, a, leq=True)
    return torch.cat([pa, pb])
