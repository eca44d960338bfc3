"""The benchmark's plain reference and the comparison that decides
``correct``; plain NumPy, importing nothing of the program."""

from .compare import compare_gets, compare_scans
from .model import StreamModel

__all__ = ["StreamModel", "compare_gets", "compare_scans"]
