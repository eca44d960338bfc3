"""Disjointization of effective areas (paper §4.2, Fig. 5-6, Lemma 4.2).

Overlapping effective areas are reorganized so that each key interval is
covered by at most one rectangle.  Where two areas overlap in key space, the
*more recent* one (larger ``smax``) dominates; when their sequence intervals
overlap or touch, their coverage union is itself an interval and the output
rectangle carries ``[min(smin), max(smax))`` — exactly the paper's cases
(a)/(b)/(c) with the trimming-safety argument of §4.2.  When the sequence
intervals have a gap (which, under the system invariant, only happens when
the older area lies entirely below the GC floor and is therefore vacuous for
live entries), the dominated area's coverage is dropped, matching the
paper's winner-only rule.

The paper builds the disjoint set with a heap sweep.  On data-parallel hardware
a data-parallel formulation is preferable, so we implement disjointization
as divide-and-conquer over a **vectorized two-way streaming merge** — the
same primitive the LSM-DRtree compaction uses (§4.2 "Construction of
LSM-DRtree").  Output size is at most 2n-1 rectangles, matching the paper's
"no more than twice the original set" bound.
"""

from __future__ import annotations

import numpy as np

from .areas import AreaSet, UKEY

UMAX = np.iinfo(np.uint64).max


def _coalesce(lo, hi, smin, smax) -> AreaSet:
    """Coalesce contiguous segments of a disjoint sorted run that carry
    identical seq rectangles — the canonicalization step shared by the
    two-way merge and the sorted-run fast path of ``disjointize``."""
    brk = np.ones(len(lo), dtype=bool)
    brk[1:] = ((lo[1:] != hi[:-1]) | (smin[1:] != smin[:-1])
               | (smax[1:] != smax[:-1]))
    starts = np.flatnonzero(brk)
    ends = np.append(starts[1:], len(lo))
    return AreaSet(lo[starts], hi[ends - 1], smin[starts], smax[starts])


def merge_disjoint(a: AreaSet, b: AreaSet) -> AreaSet:
    """Merge two canonical (sorted, key-disjoint) area sets into one.

    This is the LSM-DRtree compaction primitive: a streaming two-way merge
    with pairwise disjointization, vectorized over elementary key intervals.
    Cost is O((n+m) log(n+m)) host work and — when charged by the caller —
    sequential I/O over both inputs and the output.
    """
    if len(a) == 0:
        return b
    if len(b) == 0:
        return a

    bounds = np.unique(
        np.concatenate([a.lo, a.hi, b.lo, b.hi]).astype(np.uint64))
    seg_lo = bounds[:-1]
    seg_hi = bounds[1:]

    def cover(s: AreaSet):
        idx = np.searchsorted(s.lo, seg_lo, side="right").astype(np.int64) - 1
        idxc = np.maximum(idx, 0)
        cov = (idx >= 0) & (seg_lo < s.hi[idxc])
        return cov, idxc

    cov_a, ia = cover(a)
    cov_b, ib = cover(b)

    smax_a = np.where(cov_a, a.smax[ia], UKEY(0))
    smax_b = np.where(cov_b, b.smax[ib], UKEY(0))
    smin_a = np.where(cov_a, a.smin[ia], UKEY(UMAX))
    smin_b = np.where(cov_b, b.smin[ib], UKEY(UMAX))

    a_wins = smax_a >= smax_b
    w_smax = np.maximum(smax_a, smax_b)
    w_smin = np.where(a_wins, smin_a, smin_b)
    l_smax = np.where(a_wins, smax_b, smax_a)

    both = cov_a & cov_b
    # Sequence intervals chain into one interval iff winner.smin <= loser.smax
    union_ok = both & (w_smin <= l_smax)
    out_smin = np.where(union_ok, np.minimum(smin_a, smin_b), w_smin)
    out_smax = w_smax
    keep = cov_a | cov_b

    lo_k = seg_lo[keep]
    hi_k = seg_hi[keep]
    smin_k = out_smin[keep]
    smax_k = out_smax[keep]

    if len(lo_k) == 0:
        return AreaSet.empty()

    # Coalesce contiguous segments with identical seq rectangles.
    return _coalesce(lo_k, hi_k, smin_k, smax_k)


def disjointize(s: AreaSet) -> AreaSet:
    """Disjointize an arbitrary set of effective areas (flush path).

    Columnar and loop-free per record: the set is sorted by ``lo`` once,
    split at the overlap points into maximal runs that are *already*
    key-disjoint (vectorized break detection — a fully disjoint input
    needs zero merges), each run is canonicalized, and the runs are then
    reduced bottom-up with the vectorized two-way streaming merge.
    Output is canonical (sorted by lo, key-disjoint, coalesced) —
    equivalent to the paper's heap sweep under the system invariant
    (all live ``smin`` at the GC floor).
    """
    n = len(s)
    if n == 0:
        return s
    assert bool(np.all(s.lo < s.hi)) and bool(np.all(s.smin < s.smax))
    srt = s.sorted_by_lo()
    brk = np.flatnonzero(srt.hi[:-1] > srt.lo[1:]) + 1
    bounds = np.concatenate([[0], brk, [n]])
    parts = [_coalesce(srt.lo[a:b], srt.hi[a:b], srt.smin[a:b],
                       srt.smax[a:b])
             for a, b in zip(bounds[:-1].tolist(), bounds[1:].tolist())]
    while len(parts) > 1:
        nxt = [merge_disjoint(parts[i], parts[i + 1])
               for i in range(0, len(parts) - 1, 2)]
        if len(parts) % 2:
            nxt.append(parts[-1])
        parts = nxt
    return parts[0]


def disjointize_arrays(lo, hi, smin, smax) -> AreaSet:
    """Columnar entry point: disjointize four flat record arrays
    directly (no per-record tuples — the staging-buffer flush shape)."""
    return disjointize(AreaSet.from_arrays(lo, hi, smin, smax))


def disjointize_oracle(s: AreaSet) -> AreaSet:
    """Brute-force reference: elementary segments x O(n) coverage.

    Only used by tests.  Implements the ideal union semantics
    (per-segment seq coverage = [min smin, max smax) over covering areas),
    which is exact under the system invariant.
    """
    if len(s) == 0:
        return s
    bounds = np.unique(np.concatenate([s.lo, s.hi]).astype(np.uint64))
    seg_lo = bounds[:-1]
    seg_hi = bounds[1:]
    cov = (s.lo[None, :] <= seg_lo[:, None]) & (seg_lo[:, None] < s.hi[None, :])
    any_cov = cov.any(axis=1)
    smax = np.where(cov, s.smax[None, :], UKEY(0)).max(axis=1)
    smin = np.where(cov, s.smin[None, :], UKEY(UMAX)).min(axis=1)
    lo_k, hi_k = seg_lo[any_cov], seg_hi[any_cov]
    smin_k, smax_k = smin[any_cov], smax[any_cov]
    if len(lo_k) == 0:
        return AreaSet.empty()
    brk = np.ones(len(lo_k), dtype=bool)
    brk[1:] = ((lo_k[1:] != hi_k[:-1]) | (smin_k[1:] != smin_k[:-1])
               | (smax_k[1:] != smax_k[:-1]))
    starts = np.flatnonzero(brk)
    ends = np.append(starts[1:], len(lo_k))
    return AreaSet(lo_k[starts], hi_k[ends - 1], smin_k[starts],
                   smax_k[starts])
