from .ops import interval_query
from .ref import interval_query_ref

__all__ = ["interval_query", "interval_query_ref"]
