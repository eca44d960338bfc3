"""Effective areas: the paper's 2-D representation of range deletes.

A range delete over keys ``[lo, hi)`` issued at sequence number ``s``
invalidates every entry whose key lies in ``[lo, hi)`` and whose sequence
number lies in ``[smin, smax)`` with ``smax = s`` (entries written *before*
the delete) and ``smin`` the GC floor at issue time (entries below the floor
are guaranteed already purged from the LSM-tree, so coverage below it is
vacuous).  That rectangle in (key x seqno) *working space* is the record's
**effective area** (paper §4.1, Lemma 4.1).

Areas are stored struct-of-arrays: four equal-length uint64 numpy arrays
``(lo, hi, smin, smax)``.  Intervals are half-open on both axes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

UKEY = np.uint64


@dataclass(frozen=True)
class AreaSet:
    """A set of effective areas (not necessarily disjoint)."""

    lo: np.ndarray
    hi: np.ndarray
    smin: np.ndarray
    smax: np.ndarray

    def __post_init__(self):
        n = len(self.lo)
        assert len(self.hi) == len(self.smin) == len(self.smax) == n

    def __len__(self) -> int:
        return len(self.lo)

    @staticmethod
    def empty() -> "AreaSet":
        z = np.zeros(0, dtype=UKEY)
        return AreaSet(z, z.copy(), z.copy(), z.copy())

    @staticmethod
    def from_records(records) -> "AreaSet":
        """records: iterable of (lo, hi, smin, smax)."""
        arr = np.asarray(list(records), dtype=np.uint64)
        if arr.size == 0:
            return AreaSet.empty()
        return AreaSet(arr[:, 0].copy(), arr[:, 1].copy(),
                       arr[:, 2].copy(), arr[:, 3].copy())

    @staticmethod
    def from_arrays(lo, hi, smin, smax) -> "AreaSet":
        """Columnar constructor: four flat arrays, no per-record tuples
        (the staging-buffer / engine-batch shape)."""
        return AreaSet(np.asarray(lo, dtype=UKEY), np.asarray(hi, dtype=UKEY),
                       np.asarray(smin, dtype=UKEY),
                       np.asarray(smax, dtype=UKEY))

    def to_records(self) -> np.ndarray:
        return np.stack([self.lo, self.hi, self.smin, self.smax], axis=1)

    def nbytes(self, key_size: int) -> int:
        """On-disk footprint per the paper's model: one record ~= 2 keys
        (sequence numbers are 'much smaller than the keys')."""
        return len(self) * 2 * key_size

    def covers_point_bruteforce(self, key: int, seq: int) -> bool:
        """O(n) oracle: is (key, seq) inside any rectangle?"""
        key = UKEY(key)
        seq = UKEY(seq)
        return bool(
            np.any((self.lo <= key) & (key < self.hi)
                   & (self.smin <= seq) & (seq < self.smax)))

    def covers_batch_bruteforce(self, keys: np.ndarray,
                                seqs: np.ndarray) -> np.ndarray:
        keys = np.asarray(keys, dtype=UKEY)[:, None]
        seqs = np.asarray(seqs, dtype=UKEY)[:, None]
        if len(self) == 0:
            return np.zeros(keys.shape[0], dtype=bool)
        return np.any((self.lo[None, :] <= keys) & (keys < self.hi[None, :])
                      & (self.smin[None, :] <= seqs)
                      & (seqs < self.smax[None, :]), axis=1)

    def sorted_by_lo(self) -> "AreaSet":
        order = np.argsort(self.lo, kind="stable")
        return AreaSet(self.lo[order], self.hi[order], self.smin[order],
                       self.smax[order])

    def concat(self, other: "AreaSet") -> "AreaSet":
        return AreaSet(np.concatenate([self.lo, other.lo]),
                       np.concatenate([self.hi, other.hi]),
                       np.concatenate([self.smin, other.smin]),
                       np.concatenate([self.smax, other.smax]))

    def is_disjoint_sorted(self) -> bool:
        """Canonical DR-tree level form: sorted by lo, key-disjoint."""
        if len(self) <= 1:
            return bool(np.all(self.lo < self.hi)) if len(self) else True
        ok = np.all(self.lo < self.hi)
        ok &= np.all(self.hi[:-1] <= self.lo[1:])
        return bool(ok)


def make_area(lo: int, hi: int, seq: int, floor: int = 0) -> tuple:
    """Effective area of a range delete [lo, hi) issued at sequence ``seq``.

    It kills entries with seq' < ``seq`` (strictly earlier writes), i.e. the
    half-open seq interval [floor, seq).
    """
    assert lo < hi, "empty key range"
    assert floor < seq, "range delete must postdate the GC floor"
    return (int(lo), int(hi), int(floor), int(seq))
