"""LSM-tree key-value substrate with simulated-I/O accounting."""

from .format import LSMConfig, PUT, TOMBSTONE
from .sstable import RangeTombstoneBlock, SSTable, build_sstable
from .tree import CascadeVerdict, LSMTree, STRATEGIES

__all__ = ["LSMConfig", "PUT", "TOMBSTONE", "RangeTombstoneBlock", "SSTable",
           "build_sstable", "CascadeVerdict", "LSMTree", "STRATEGIES"]
