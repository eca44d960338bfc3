"""Columnar staging buffer for range-record inserts (LSM-DRtree buffer).

The paper's Lemma 4.3 update cost assumes the write buffer absorbs
range-record inserts *cheaply* before disjointize-on-flush — and the
buffer only ever needs three operations: append (absorb a range delete),
point stabbing (is (key, seq) covered?), and full drain (flush).  A
general R-tree (``core.rtree``) pays a per-record Python descent for
each of those; this buffer instead keeps the records as four flat
``uint64`` arrays ``(lo, hi, smin, smax)`` with geometric growth, so

  insert / insert_batch   amortized O(1) per record, vectorized —
                          a whole engine plan step lands as one append,
  covers / covers_batch   ``searchsorted`` over a lazily maintained
                          **disjointized view** (``core.disjointize``):
                          appends since the last probe are disjointized
                          as one chunk and two-way merged into the view
                          (the same streaming primitive compaction
                          uses), so probe cost is O(log n) per query and
                          the disjointize work is amortized over bursts,
  drain_disjoint          the flush path: the fully-merged view, equal
                          to ``disjointize(extract_all())`` under the
                          system invariant (all live ``smin`` at the GC
                          floor — what ``GloranIndex.range_delete``
                          always inserts).

The raw insertion-order records stay resident (``extract_all``), so the
buffer is also a drop-in for the R-tree's extract/clear protocol and
flush trigger points are unchanged (``size`` counts raw records).
"""

from __future__ import annotations

import numpy as np

from .areas import AreaSet, UKEY
from .disjointize import disjointize, merge_disjoint

_MIN_ALLOC = 64


class StagingBuffer:
    """Vectorized write buffer over effective areas (working-space rects)."""

    def __init__(self, capacity_hint: int = 0):
        m = max(_MIN_ALLOC, int(capacity_hint))
        self._lo = np.empty(m, dtype=UKEY)
        self._hi = np.empty(m, dtype=UKEY)
        self._smin = np.empty(m, dtype=UKEY)
        self._smax = np.empty(m, dtype=UKEY)
        self.size = 0
        self._view = AreaSet.empty()  # disjointized probe view
        self._view_n = 0  # raw records already folded into the view

    # ------------------------------------------------------------- insert
    def _grow(self, need: int) -> None:
        cap = len(self._lo)
        if self.size + need <= cap:
            return
        new = max(cap * 2, self.size + need)
        for name in ("_lo", "_hi", "_smin", "_smax"):
            arr = np.empty(new, dtype=UKEY)
            arr[:self.size] = getattr(self, name)[:self.size]
            setattr(self, name, arr)

    def insert(self, lo: int, hi: int, smin: int, smax: int) -> None:
        """Append one effective area (same signature as ``RTree.insert``)."""
        assert lo < hi and smin < smax
        self._grow(1)
        i = self.size
        self._lo[i] = lo
        self._hi[i] = hi
        self._smin[i] = smin
        self._smax[i] = smax
        self.size = i + 1

    def insert_batch(self, los, his, smins, smaxs) -> None:
        """Append a batch of effective areas as one vectorized copy."""
        los = np.asarray(los, dtype=UKEY)
        his = np.asarray(his, dtype=UKEY)
        smins = np.asarray(smins, dtype=UKEY)
        smaxs = np.asarray(smaxs, dtype=UKEY)
        n = len(los)
        if n == 0:
            return
        assert (los < his).all() and (smins < smaxs).all()
        self._grow(n)
        i = self.size
        self._lo[i:i + n] = los
        self._hi[i:i + n] = his
        self._smin[i:i + n] = smins
        self._smax[i:i + n] = smaxs
        self.size = i + n

    # -------------------------------------------------------------- query
    def _refresh_view(self) -> None:
        """Fold records appended since the last probe into the disjoint
        view: one ``disjointize`` over the pending chunk, one streaming
        two-way ``merge_disjoint`` with the existing view."""
        if self._view_n == self.size:
            return
        pend = AreaSet(self._lo[self._view_n:self.size].copy(),
                       self._hi[self._view_n:self.size].copy(),
                       self._smin[self._view_n:self.size].copy(),
                       self._smax[self._view_n:self.size].copy())
        d = disjointize(pend)
        self._view = merge_disjoint(self._view, d) if len(self._view) else d
        self._view_n = self.size

    @property
    def view(self) -> AreaSet:
        """The up-to-date disjointized probe view (canonical AreaSet)."""
        self._refresh_view()
        return self._view

    @property
    def view_records(self) -> int:
        """Records currently resident in the probe view (no build)."""
        return len(self._view)

    def covers(self, key: int, seq: int) -> bool:
        """Is (key, seq) inside any buffered rectangle?"""
        if self.size == 0:
            return False
        v = self.view
        key = UKEY(key)
        idx = int(np.searchsorted(v.lo, key, side="right")) - 1
        if idx < 0:
            return False
        return bool(key < v.hi[idx]
                    and v.smin[idx] <= UKEY(seq) < v.smax[idx])

    def covers_batch(self, keys: np.ndarray, seqs: np.ndarray) -> np.ndarray:
        """Vectorized point stabbing: one ``searchsorted`` over the
        disjoint view for the whole batch (vs. the R-tree's per-query
        multi-child descents)."""
        keys = np.asarray(keys, dtype=UKEY)
        seqs = np.asarray(seqs, dtype=UKEY)
        if self.size == 0 or len(keys) == 0:
            return np.zeros(len(keys), dtype=bool)
        v = self.view
        idx = np.searchsorted(v.lo, keys, side="right").astype(np.int64) - 1
        idxc = np.maximum(idx, 0)
        return ((idx >= 0) & (keys < v.hi[idxc]) & (v.smin[idxc] <= seqs)
                & (seqs < v.smax[idxc]))

    # ------------------------------------------------------------ extract
    def extract_all(self) -> AreaSet:
        """Raw records in insertion order (the R-tree extract protocol)."""
        return AreaSet(self._lo[:self.size].copy(),
                       self._hi[:self.size].copy(),
                       self._smin[:self.size].copy(),
                       self._smax[:self.size].copy())

    def drain_disjoint(self) -> AreaSet:
        """The flush product: every buffered record, disjointized.

        Equal to ``disjointize(self.extract_all())`` under the system
        invariant (unique canonical form of the union coverage), but
        reuses whatever part of the view probes already paid for.
        """
        return self.view

    def clear(self) -> None:
        self.size = 0
        self._view = AreaSet.empty()
        self._view_n = 0

    # ---------------------------------------------------------------- misc
    def model_bytes(self, key_size: int) -> int:
        """Resident footprint per the paper's model: each record keeps
        all four key-sized fields in memory, and the disjointized probe
        view (at most 2x records) is resident alongside them."""
        return (self.size + len(self._view)) * 4 * key_size

    @property
    def nbytes(self) -> int:
        """Actual allocated bytes (flat arrays + probe view)."""
        arrs = (self._lo, self._hi, self._smin, self._smax)
        view = (self._view.lo, self._view.hi, self._view.smin,
                self._view.smax)
        return sum(a.nbytes for a in arrs) + sum(a.nbytes for a in view)

    def __len__(self) -> int:
        return self.size
