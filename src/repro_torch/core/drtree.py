"""DR-tree: static disjoint R-tree over disjointized effective areas.

Because leaves are key-disjoint and key-sorted (Lemma 4.2), at most ONE node
per tree level can cover a query key, so a point probe touches exactly
``height`` nodes: O(log_D n) worst case — the paper's core improvement over
the R-tree's overlap-induced multi-child descents.

Serialized form ("on disk"): the four sorted leaf arrays ``(lo, hi, smin,
smax)`` packed into B-byte blocks, plus fanout-D internal levels of fence
keys.  The data path is a batched binary search (`searchsorted`, and the
CUDA `interval_query` kernel on device); the node structure exists for
faithful I/O accounting per Eq. (2).
"""

from __future__ import annotations

import math

import numpy as np

from .areas import AreaSet, UKEY
from .iostats import IOStats


class DRTree:
    """Immutable disjoint R-tree level of an LSM-DRtree."""

    def __init__(self, areas: AreaSet, *, key_size: int = 16,
                 block_size: int = 4096, fanout: int | None = None):
        assert areas.is_disjoint_sorted(), "DR-tree needs canonical areas"
        self.areas = areas
        self.key_size = key_size
        self.block_size = block_size
        # One record ~= 2 keys (paper: seqnos are much smaller than keys).
        record = 2 * key_size
        self.leaf_cap = max(2, block_size // record)
        self.fanout = int(fanout) if fanout else self.leaf_cap
        assert self.fanout >= 2
        n = len(areas)
        self.n_leaves = max(1, math.ceil(n / self.leaf_cap))
        # Height counts node levels root..leaf (>=1); internal levels shrink
        # by D.
        h = 1
        m = self.n_leaves
        while m > 1:
            m = math.ceil(m / self.fanout)
            h += 1
        self.height = h

    @classmethod
    def from_arrays(cls, lo, hi, smin, smax, **kwargs) -> "DRTree":
        """Columnar bulk load: four flat canonical arrays (sorted by lo,
        key-disjoint) straight into a level — no per-record loop."""
        return cls(AreaSet.from_arrays(lo, hi, smin, smax), **kwargs)

    def __len__(self) -> int:
        return len(self.areas)

    @property
    def nbytes(self) -> int:
        # Leaves + geometric internal overhead D/(D-1) (paper Eq. 3).
        leaf_bytes = len(self.areas) * 2 * self.key_size
        return int(leaf_bytes * self.fanout / max(1, self.fanout - 1))

    # ------------------------------------------------------------- probes
    def probe_cost(self) -> int:
        """I/Os for one point probe: one node per level (Lemma 4.4)."""
        return self.height

    def query(self, key: int, seq: int, io: IOStats | None = None) -> bool:
        if io is not None:
            io.read_blocks(self.probe_cost(), tag="drtree_probe")
        a = self.areas
        if len(a) == 0:
            return False
        key = UKEY(key)
        idx = int(np.searchsorted(a.lo, key, side="right")) - 1
        if idx < 0:
            return False
        return bool(key < a.hi[idx] and a.smin[idx] <= UKEY(seq) < a.smax[idx])

    def query_batch(self, keys: np.ndarray, seqs: np.ndarray,
                    io: IOStats | None = None) -> np.ndarray:
        keys = np.asarray(keys, dtype=np.uint64)
        seqs = np.asarray(seqs, dtype=np.uint64)
        if io is not None:
            io.read_blocks(self.probe_cost() * len(keys), tag="drtree_probe")
        a = self.areas
        if len(a) == 0:
            return np.zeros(len(keys), dtype=bool)
        idx = np.searchsorted(a.lo, keys, side="right").astype(np.int64) - 1
        idxc = np.maximum(idx, 0)
        return ((idx >= 0) & (keys < a.hi[idxc]) & (a.smin[idxc] <= seqs)
                & (seqs < a.smax[idxc]))

    # --------------------------------------------------------------- scan
    def scan_io(self) -> int:
        """Sequential I/Os to stream the whole level (compaction/iterators)."""
        return math.ceil(len(self.areas) * 2 * self.key_size /
                         self.block_size) if len(self.areas) else 0

    def gc(self, watermark: int) -> "DRTree":
        """Drop areas fully below the watermark; raise floors to it.

        An area with smax <= watermark only covers sequence numbers whose
        matching entries are guaranteed purged (bottom-compaction watermark),
        so it is vacuous for live entries (paper §4.4).
        """
        a = self.areas
        keep = a.smax > UKEY(watermark)
        sm = np.maximum(a.smin[keep], UKEY(watermark))
        return DRTree(AreaSet(a.lo[keep], a.hi[keep], sm, a.smax[keep]),
                      key_size=self.key_size, block_size=self.block_size,
                      fanout=self.fanout)
