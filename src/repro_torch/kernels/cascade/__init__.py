from .ops import CascadeState, cascade_lookup, cascade_masks
from .ref import cascade_ref

__all__ = ["CascadeState", "cascade_lookup", "cascade_masks", "cascade_ref"]
