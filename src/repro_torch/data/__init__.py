"""Dataset-side code: the token pipeline training reads, and stores on
the port's LSM-tree."""

from .pipeline import PipelineConfig, TokenPipeline
from .versioned_store import VersionedSampleStore

__all__ = ["PipelineConfig", "TokenPipeline", "VersionedSampleStore"]
