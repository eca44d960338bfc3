from .ops import ssd_chunked_scan, ssd_chunks
from .ref import ssd_chunks_ref

__all__ = ["ssd_chunked_scan", "ssd_chunks", "ssd_chunks_ref"]
