"""Memtable snapshots and range-tombstone density for the LSM tree.

The tree reads ``FrozenMemtable`` snapshots between its active memtable
and its levels; ``level_rt_density`` feeds the per-level
``rt_density`` stat.  Background compaction scheduling is not part of
this package yet: the tree's ``scheduler`` attribute stays None, so a
full memtable always flushes inline.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

_PROACTIVE_SAMPLE = 256  # EVE probes per level-density estimate


@dataclass
class FrozenMemtable:
    """One sealed, immutable memtable: the key-sorted columnar snapshot
    (unique keys — the dict semantics already resolved overwrites) plus
    the LRR range-tombstone buffer that sealed with it."""

    keys: np.ndarray
    seqs: np.ndarray
    types: np.ndarray
    vals: np.ndarray
    rts: list = field(default_factory=list)  # [(lo, hi, seq)] (LRR)

    @property
    def min_seq(self) -> int:
        return int(self.seqs.min()) if len(self.seqs) else 0

    def __len__(self) -> int:
        return len(self.keys)


def level_rt_density(tree, i: int) -> float:
    """Estimated fraction of level ``i``'s entries covered by a live
    range tombstone — the scheduler's Lethe priority input, also
    surfaced per level in ``engine.stats()``.

    LRR: exact ratio of the level's range-tombstone block to its run.
    GLORAN: EVE-sampled — probe an evenly-spaced deterministic sample
    of the level's (key, seq) pairs through the estimator (no I/O; the
    estimator is the in-memory structure the paper builds for exactly
    this maybe-deleted question) and return the maybe-covered fraction.
    Other strategies carry no range-tombstone metadata: 0.0.
    """
    lvl = tree.levels[i] if i < len(tree.levels) else None
    n = len(lvl) if lvl is not None else 0
    if tree.strategy == "lrr":
        nrt = len(tree.level_rts[i]) if i < len(tree.level_rts) else 0
        return nrt / max(n, 1)
    if tree.strategy == "gloran" and tree.gloran is not None and n:
        gl = tree.gloran
        if gl.num_range_deletes == 0 or gl.eve is None:
            return 0.0
        m = min(n, _PROACTIVE_SAMPLE)
        idx = np.linspace(0, n - 1, m).astype(np.int64)
        maybe = gl.eve.maybe_deleted_batch(lvl.keys[idx], lvl.seqs[idx])
        return float(np.mean(maybe))
    return 0.0
