"""Read-through LRU block cache with hit/miss accounting.

The I/O simulator charges one block read per data-block access; repeated
session lookups in the serving tier keep re-reading the same hot blocks.
The cache models a block cache in front of the simulated disk: a hit
skips the charge, a miss charges it and admits the block.  Keys are
``(run_uid, block_index)`` — run uids are process-unique, so blocks of
compacted-away runs are never falsely hit and simply age out of the LRU.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np


class BlockCache:
    def __init__(self, capacity_blocks: int = 0):
        self.capacity = int(capacity_blocks)
        self._blocks: OrderedDict[tuple[int, int], None] = OrderedDict()
        self.hits = 0
        self.misses = 0
        # Per-op-class attribution: the executor tags each probe window
        # with the op class it serves ("get" vs "range_scan"), so scan
        # and point-lookup cache behavior stay distinguishable in the
        # global ledger.
        self.op_class: str | None = None
        self.class_hits: dict[str, int] = {}
        self.class_misses: dict[str, int] = {}

    @property
    def enabled(self) -> bool:
        return self.capacity > 0

    def __len__(self) -> int:
        return len(self._blocks)

    def probe_many(self, run_uid: int, blocks: np.ndarray) -> np.ndarray:
        """Read-through probe: bool hit mask per block, misses admitted.

        Duplicate block indices within one call count one miss + n-1 hits,
        matching what a real cache would do for a sorted probe batch.
        """
        hit = np.zeros(len(blocks), dtype=bool)
        cls = self.op_class or "other"
        if not self.enabled:
            self.misses += len(blocks)
            self.class_misses[cls] = \
                self.class_misses.get(cls, 0) + len(blocks)
            return hit
        for j, b in enumerate(blocks.tolist()):
            key = (run_uid, int(b))
            if key in self._blocks:
                self._blocks.move_to_end(key)
                hit[j] = True
            else:
                self._blocks[key] = None
                if len(self._blocks) > self.capacity:
                    self._blocks.popitem(last=False)
        h = int(hit.sum())
        m = int((~hit).sum())
        self.hits += h
        self.misses += m
        self.class_hits[cls] = self.class_hits.get(cls, 0) + h
        self.class_misses[cls] = self.class_misses.get(cls, 0) + m
        return hit

    def by_class(self) -> dict:
        """Per-op-class hit/miss/hit-rate breakdown of the ledger."""
        out = {}
        for cls in sorted(set(self.class_hits) | set(self.class_misses)):
            h = self.class_hits.get(cls, 0)
            m = self.class_misses.get(cls, 0)
            out[cls] = {"hits": h, "misses": m,
                        "hit_rate": h / (h + m) if h + m else 0.0}
        return out

    def snapshot(self) -> dict:
        total = self.hits + self.misses
        return {
            "capacity_blocks": self.capacity,
            "resident_blocks": len(self._blocks),
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hits / total if total else 0.0,
            "by_class": self.by_class(),
        }

    def clear(self) -> None:
        self._blocks.clear()
