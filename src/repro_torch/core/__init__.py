"""GLORAN core: effective areas, disjointization, DR-tree / LSM-DRtree,
EVE validity estimator, and I/O accounting (the paper's primary
contribution, §4)."""

from .areas import AreaSet, make_area
from .disjointize import (disjointize, disjointize_arrays,
                          disjointize_oracle, merge_disjoint)
from .drtree import DRTree
from .eve import EVE, RAE, BloomBits, RAEConfig
from .gloran import GloranConfig, GloranIndex
from .iostats import IOStats, ScopedIO
from .lsm_drtree import LSMDRTree, LSMDRTreeConfig, LSMRTree
from .rtree import RTree
from .staging import StagingBuffer

__all__ = [
    "AreaSet", "make_area", "disjointize", "disjointize_arrays",
    "disjointize_oracle", "merge_disjoint", "DRTree", "EVE", "RAE",
    "BloomBits", "RAEConfig", "GloranConfig", "GloranIndex", "IOStats",
    "ScopedIO", "LSMDRTree", "LSMDRTreeConfig", "LSMRTree", "RTree",
    "StagingBuffer",
]
