"""In-memory R-tree over effective areas (working space rectangles).

Two roles (paper §4.2):
  1. Write buffer of the LSM-DRtree: absorbs range-record inserts cheaply
     before a flush disjointizes its contents into a DR-tree.
  2. The GLORAN0 / LSM-Rtree baseline (Fig. 13a): levels store *raw*,
     possibly-overlapping areas in R-trees, so a point query may descend
     multiple children per node — the node-visit counter exposes exactly the
     tail-latency pathology the paper attributes to MBR overlap.

Classic Guttman R-tree with quadratic split.  Rectangles are half-open
[lo, hi) x [smin, smax) in (key x seqno) working space.
"""

from __future__ import annotations

import numpy as np

from .areas import AreaSet


class _Node:
    __slots__ = ("leaf", "entries", "mbr")

    def __init__(self, leaf: bool):
        self.leaf = leaf
        self.entries = []  # leaf: [(rect)], internal: [_Node]
        self.mbr = None  # (lo, hi, smin, smax)


def _rect_of(e):
    return e.mbr if isinstance(e, _Node) else e


def _union(r1, r2):
    if r1 is None:
        return r2
    if r2 is None:
        return r1
    return (min(r1[0], r2[0]), max(r1[1], r2[1]), min(r1[2], r2[2]),
            max(r1[3], r2[3]))


def _area(r):
    return (r[1] - r[0]) * (r[3] - r[2])


def _enlargement(mbr, r):
    u = _union(mbr, r)
    return _area(u) - _area(mbr)


def _contains_point(r, key: int, seq: int) -> bool:
    return r[0] <= key < r[1] and r[2] <= seq < r[3]


class RTree:
    """Point-stabbing R-tree with a node-visit counter."""

    def __init__(self, max_entries: int = 16):
        self.max_entries = max_entries
        self.min_entries = max(2, max_entries // 3)
        self.root = _Node(leaf=True)
        self.size = 0
        self.node_visits = 0  # cumulative, for I/O accounting of GLORAN0

    # ------------------------------------------------------------- insert
    def insert(self, lo: int, hi: int, smin: int, smax: int) -> None:
        rect = (int(lo), int(hi), int(smin), int(smax))
        split = self._insert(self.root, rect)
        if split is not None:
            old_root = self.root
            self.root = _Node(leaf=False)
            self.root.entries = [old_root, split]
            self.root.mbr = _union(old_root.mbr, split.mbr)
        self.size += 1

    def _insert(self, node: _Node, rect):
        node.mbr = _union(node.mbr, rect)
        if node.leaf:
            node.entries.append(rect)
        else:
            best = min(node.entries,
                       key=lambda c: (_enlargement(c.mbr, rect), _area(c.mbr)))
            split = self._insert(best, rect)
            if split is not None:
                node.entries.append(split)
        if len(node.entries) > self.max_entries:
            return self._split(node)
        return None

    def _split(self, node: _Node):
        entries = node.entries
        rects = [_rect_of(e) for e in entries]
        # Quadratic pick-seeds: pair wasting the most area.
        worst, seeds = -1.0, (0, 1)
        for i in range(len(rects)):
            for j in range(i + 1, len(rects)):
                waste = _area(_union(rects[i], rects[j])) - _area(
                    rects[i]) - _area(rects[j])
                if waste > worst:
                    worst, seeds = waste, (i, j)
        i, j = seeds
        g1, g2 = [entries[i]], [entries[j]]
        m1, m2 = rects[i], rects[j]
        rest = [e for k, e in enumerate(entries) if k not in (i, j)]
        for e in rest:
            r = _rect_of(e)
            need1 = self.min_entries - len(g1)
            need2 = self.min_entries - len(g2)
            remaining = len(rest) - (len(g1) + len(g2) - 2)
            if need1 >= remaining:
                g1.append(e)
                m1 = _union(m1, r)
            elif need2 >= remaining:
                g2.append(e)
                m2 = _union(m2, r)
            elif _enlargement(m1, r) <= _enlargement(m2, r):
                g1.append(e)
                m1 = _union(m1, r)
            else:
                g2.append(e)
                m2 = _union(m2, r)
        node.entries, node.mbr = g1, m1
        sib = _Node(leaf=node.leaf)
        sib.entries, sib.mbr = g2, m2
        return sib

    # -------------------------------------------------------------- query
    def covers(self, key: int, seq: int) -> bool:
        """Is (key, seq) inside any stored rectangle?  Counts node visits."""
        return self._covers(self.root, int(key), int(seq))

    def _covers(self, node: _Node, key: int, seq: int) -> bool:
        self.node_visits += 1
        if node.mbr is None or not _contains_point(node.mbr, key, seq):
            return False
        if node.leaf:
            return any(_contains_point(r, key, seq) for r in node.entries)
        return any(self._covers(c, key, seq) for c in node.entries
                   if _contains_point(c.mbr, key, seq))

    def covers_batch(self, keys: np.ndarray, seqs: np.ndarray) -> np.ndarray:
        """Vectorized point stabbing for a batch of (key, seq) queries.

        Descends the tree once with index masks instead of once per query;
        ``node_visits`` advances by the number of still-undecided queries
        reaching each node, mirroring the per-query descent cost that the
        GLORAN0 I/O accounting is built on.
        """
        keys = np.asarray(keys, dtype=np.uint64)
        seqs = np.asarray(seqs, dtype=np.uint64)
        out = np.zeros(len(keys), dtype=bool)
        if len(keys) == 0:
            return out
        stack = [(self.root, np.arange(len(keys)))]
        while stack:
            node, idx = stack.pop()
            idx = idx[~out[idx]]  # short-circuit queries already covered
            if len(idx) == 0:
                continue
            self.node_visits += len(idx)
            if node.mbr is None:
                continue
            lo, hi, smin, smax = node.mbr
            k, s = keys[idx], seqs[idx]
            inside = (k >= lo) & (k < hi) & (s >= smin) & (s < smax)
            idx = idx[inside]
            if len(idx) == 0:
                continue
            k, s = keys[idx], seqs[idx]
            if node.leaf:
                for r in node.entries:
                    hit = (k >= r[0]) & (k < r[1]) & (s >= r[2]) & (s < r[3])
                    out[idx[hit]] = True
            else:
                for child in node.entries:
                    clo, chi, csmin, csmax = child.mbr
                    m = (k >= clo) & (k < chi) & (s >= csmin) & (s < csmax)
                    if m.any():
                        stack.append((child, idx[m]))
        return out

    def visits_for(self, key: int, seq: int) -> int:
        """Node visits for a single query (the Fig. 13a metric)."""
        before = self.node_visits
        self._covers(self.root, int(key), int(seq))
        return self.node_visits - before

    # ------------------------------------------------------------ extract
    def extract_all(self) -> AreaSet:
        recs = []
        stack = [self.root]
        while stack:
            n = stack.pop()
            if n.leaf:
                recs.extend(n.entries)
            else:
                stack.extend(n.entries)
        return AreaSet.from_records(recs) if recs else AreaSet.empty()

    def clear(self) -> None:
        self.root = _Node(leaf=True)
        self.size = 0

    @staticmethod
    def bulk_load(areas: AreaSet, max_entries: int = 16) -> "RTree":
        """Sort-Tile-Recursive-ish bulk load by lo key (used by GLORAN0)."""
        t = RTree(max_entries)
        order = np.argsort(areas.lo, kind="stable")
        for i in order:
            t.insert(int(areas.lo[i]), int(areas.hi[i]), int(areas.smin[i]),
                     int(areas.smax[i]))
        return t
