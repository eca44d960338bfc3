from .ops import merge_positions, merge_rank, merge_ranks
from .ref import merge_positions_ref, merge_rank_ref

__all__ = ["merge_positions", "merge_positions_ref", "merge_rank",
           "merge_ranks", "merge_rank_ref"]
