from .ops import bloom_probe
from .ref import bloom_probe_ref

__all__ = ["bloom_probe", "bloom_probe_ref"]
