"""Dataset-side stores on the port's LSM-tree.  The token pipeline is
not ported yet (it comes with training)."""

from .versioned_store import VersionedSampleStore

__all__ = ["VersionedSampleStore"]
