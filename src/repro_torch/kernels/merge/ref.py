"""Plain PyTorch version of the merge-rank kernel."""

from __future__ import annotations

import torch

from ..u32 import widen


def merge_rank_ref(q: torch.Tensor, run: torch.Tensor, *,
                   leq: bool) -> torch.Tensor:
    """Per query, the count of ``run`` elements below it (``leq=False``)
    or at-or-below it (``leq=True``); u32 in int32 storage -> int32."""
    return torch.searchsorted(widen(run), widen(q),
                              right=leq).to(torch.int32)
