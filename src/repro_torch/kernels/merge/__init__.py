from .ops import merge_rank, merge_ranks
from .ref import merge_rank_ref

__all__ = ["merge_rank", "merge_ranks", "merge_rank_ref"]
