"""LSM-DRtree: the global range-record index (paper §4.2).

An in-memory **columnar staging buffer** (``core.staging``) absorbs
range-record inserts — one vectorized append per engine plan step, point
stabbing via searchsorted over a lazily disjointized view; a flush
disjointizes the buffer into a DR-tree pushed to level 1; level overflows
trigger streaming two-way merge compactions (``merge_disjoint``) into the
next level.  Level capacities grow by the size ratio T', so with buffer
capacity F' the structure holds Q records in O(log_T'(Q/F')) levels —
giving Lemma 4.3's update cost and Lemma 4.4's point-probe cost.  Flush
trigger points are identical to the historical per-record R-tree buffer
(flush fires exactly when ``size`` reaches F'), so level shapes and I/O
charges are unchanged by the columnar refactor.

``LSMRTree`` is the GLORAN0 baseline (Fig. 13a): identical level scheduling
but levels keep *raw* overlapping areas in bulk-loaded R-trees (and keep
the classic R-tree write buffer), so probes pay overlap-induced multi-node
descents.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..obs import span
from .areas import AreaSet, UKEY
from .disjointize import disjointize, merge_disjoint
from .drtree import DRTree
from .iostats import IOStats
from .rtree import RTree
from .staging import StagingBuffer


@dataclass
class LSMDRTreeConfig:
    buffer_capacity: int = 8192  # F' records (4 MB / 512 B in the paper)
    size_ratio: int = 10  # T'
    key_size: int = 16  # k bytes (record = 2k)
    block_size: int = 4096  # B bytes
    fanout: int | None = None  # D; defaults to B // 2k


class LSMDRTree:
    """Global index over effective areas with LSM-style levels of DR-trees."""

    def __init__(self, config: LSMDRTreeConfig | None = None,
                 io: IOStats | None = None):
        self.config = config or LSMDRTreeConfig()
        self.io = io if io is not None else IOStats(
            block_size=self.config.block_size)
        self.buffer = StagingBuffer(self.config.buffer_capacity)
        self.levels: list[DRTree | None] = []
        self.records_inserted = 0
        # Monotonic level-structure version: bumped whenever the on-disk
        # level set changes (flush, compaction cascade, GC), so device-
        # resident packed views of the levels can invalidate by epoch
        # instead of re-hashing level identities every probe.
        self.epoch = 0

    # ------------------------------------------------------------ helpers
    def _level_capacity(self, i: int) -> int:
        # Level i (0-based on-disk) holds up to F' * T'^(i+1) records.
        return self.config.buffer_capacity * self.config.size_ratio**(i + 1)

    def _make_drtree(self, areas: AreaSet) -> DRTree:
        return DRTree(areas, key_size=self.config.key_size,
                      block_size=self.config.block_size,
                      fanout=self.config.fanout)

    # ------------------------------------------------------------- insert
    def insert(self, lo: int, hi: int, smax: int, smin: int = 0) -> None:
        """Insert the effective area of one range delete."""
        assert lo < hi and smin < smax
        self.buffer.insert(lo, hi, smin, smax)
        self.records_inserted += 1
        if self.buffer.size >= self.config.buffer_capacity:
            self.flush()

    def insert_batch(self, los, his, smaxs, smins=None) -> None:
        """Absorb a batch of range-delete records in one vectorized call.

        Chunked at the buffer-capacity boundaries so flushes fire at
        exactly the points a per-record insert loop would hit — level
        shapes, disjointize inputs, and I/O charges are identical.
        """
        los = np.asarray(los, dtype=np.uint64)
        his = np.asarray(his, dtype=np.uint64)
        smaxs = np.asarray(smaxs, dtype=np.uint64)
        smins = (np.zeros(len(los), dtype=np.uint64) if smins is None
                 else np.asarray(smins, dtype=np.uint64))
        n = len(los)
        at = 0
        while at < n:
            room = self.config.buffer_capacity - self.buffer.size
            take = min(max(room, 1), n - at)
            self.buffer.insert_batch(los[at:at + take], his[at:at + take],
                                     smins[at:at + take],
                                     smaxs[at:at + take])
            at += take
            if self.buffer.size >= self.config.buffer_capacity:
                self.flush()
        self.records_inserted += n

    def flush(self) -> None:
        if self.buffer.size == 0:
            return
        with span("gloran.index_flush", n=self.buffer.size):
            areas = self.buffer.drain_disjoint()
            self.buffer.clear()
            tree = self._make_drtree(areas)
            self.io.write_sequential(len(areas) * 2 * self.config.key_size,
                                     tag="index_flush")
            self._push(0, tree)
        self.epoch += 1

    def _push(self, i: int, tree: DRTree) -> None:
        while len(self.levels) <= i:
            self.levels.append(None)
        if self.levels[i] is None:
            self.levels[i] = tree
        else:
            merged = merge_disjoint(self.levels[i].areas, tree.areas)
            self.io.read_blocks(self.levels[i].scan_io() + tree.scan_io(),
                                tag="index_compaction")
            self.io.write_sequential(len(merged) * 2 * self.config.key_size,
                                     tag="index_compaction")
            self.levels[i] = self._make_drtree(merged)
        if len(self.levels[i].areas) > self._level_capacity(i):
            overflow = self.levels[i]
            self.levels[i] = None
            self._push(i + 1, overflow)

    # -------------------------------------------------------------- query
    def covers(self, key: int, seq: int) -> bool:
        """Has (key, seq) been invalidated by any range delete?"""
        if self.buffer.size and self.buffer.covers(key, seq):
            return True
        for lvl in self.levels:
            if lvl is not None and lvl.query(key, seq, io=self.io):
                return True
        return False

    def covers_batch(self, keys: np.ndarray, seqs: np.ndarray,
                     query_fn=None) -> np.ndarray:
        """Batched point stabbing.  ``query_fn(level, keys, seqs, io)``
        optionally replaces HOW a level is probed (e.g. the CUDA
        interval kernel); charging stays the level's responsibility."""
        keys = np.asarray(keys, dtype=np.uint64)
        seqs = np.asarray(seqs, dtype=np.uint64)
        out = np.zeros(len(keys), dtype=bool)
        if self.buffer.size:
            out |= self.buffer.covers_batch(keys, seqs)
        for lvl in self.levels:
            if lvl is not None:
                todo = ~out
                if not todo.any():
                    break
                if query_fn is not None:
                    out[todo] = query_fn(lvl, keys[todo], seqs[todo],
                                         self.io)
                else:
                    out[todo] = lvl.query_batch(keys[todo], seqs[todo],
                                                io=self.io)
        return out

    def covers_batch_cov(self, keys: np.ndarray, seqs: np.ndarray,
                         level_cov: np.ndarray) -> np.ndarray:
        """Batched point stabbing from precomputed per-level verdicts.

        ``level_cov`` is (n, G) bool — column g answers "does the g-th
        non-None level cover (key, seq)" (the fused cascade kernel's
        output, bit-exact with ``DRTree.query_batch``).  This replays
        ``covers_batch``'s control flow — in-memory buffer first, then
        levels newest->oldest with covered keys early-exiting — so the
        per-level probe I/O charges are identical; only the verdict
        computation moved to the device.
        """
        keys = np.asarray(keys, dtype=np.uint64)
        seqs = np.asarray(seqs, dtype=np.uint64)
        out = np.zeros(len(keys), dtype=bool)
        if self.buffer.size:
            out |= self.buffer.covers_batch(keys, seqs)
        col = 0
        for lvl in self.levels:
            if lvl is not None:
                todo = ~out
                if not todo.any():
                    break
                assert col < level_cov.shape[1], "stale cascade view"
                self.io.read_blocks(lvl.probe_cost() * int(todo.sum()),
                                    tag="drtree_probe")
                out[todo] = level_cov[todo, col]
                col += 1
        return out

    def probe_cost(self) -> int:
        """Worst-case I/Os for one point probe (Lemma 4.4 / Eq. 2)."""
        return sum(l.probe_cost() for l in self.levels if l is not None)

    # ----------------------------------------------------------------- gc
    def gc(self, watermark: int) -> int:
        """Purge records vacuous below the bottom-compaction watermark.

        Per §4.4 GC is confined to the bottommost level, where outdated
        records concentrate.  Returns the number of records dropped.
        """
        for i in range(len(self.levels) - 1, -1, -1):
            lvl = self.levels[i]
            if lvl is not None:
                before = len(lvl)
                self.io.read_blocks(lvl.scan_io(), tag="index_gc")
                newlvl = lvl.gc(watermark)
                self.io.write_sequential(
                    len(newlvl) * 2 * self.config.key_size, tag="index_gc")
                self.levels[i] = newlvl
                self.epoch += 1
                return before - len(newlvl)
        return 0

    # ---------------------------------------------------------------- misc
    @property
    def num_records(self) -> int:
        return self.buffer.size + sum(
            len(l) for l in self.levels if l is not None)

    @property
    def nbytes(self) -> int:
        """On-disk footprint: serialized levels only (2k per record, the
        paper's model).  The in-memory write buffer is charged — at its
        full four-field in-memory width — by ``GloranIndex.memory_bytes``,
        never as disk."""
        return sum(l.nbytes for l in self.levels if l is not None)

    def all_areas(self) -> AreaSet:
        out = self.buffer.extract_all()
        for lvl in self.levels:
            if lvl is not None:
                out = out.concat(lvl.areas)
        return out


class LSMRTree:
    """GLORAN0 baseline: LSM of plain R-trees (no disjointization).

    Same buffering/level scheduling as LSMDRTree, but each on-disk level is
    a bulk-loaded R-tree over raw areas; probes are charged one I/O per
    visited node, exposing the overlap pathology of Fig. 13a.
    """

    def __init__(self, config: LSMDRTreeConfig | None = None,
                 io: IOStats | None = None):
        self.config = config or LSMDRTreeConfig()
        self.io = io if io is not None else IOStats(
            block_size=self.config.block_size)
        self.buffer = RTree()
        self.levels: list[tuple[RTree, AreaSet] | None] = []

    def _level_capacity(self, i: int) -> int:
        return self.config.buffer_capacity * self.config.size_ratio**(i + 1)

    def insert(self, lo: int, hi: int, smax: int, smin: int = 0) -> None:
        self.buffer.insert(lo, hi, smin, smax)
        if self.buffer.size >= self.config.buffer_capacity:
            self.flush()

    def insert_batch(self, los, his, smaxs, smins=None) -> None:
        """Batch absorb (API parity with ``LSMDRTree.insert_batch``).

        The baseline's R-tree buffer has no vectorized path — each
        record still pays its Python descent, which is exactly the cost
        the GLORAN0 comparison exists to expose.
        """
        los = np.asarray(los, dtype=np.uint64)
        his = np.asarray(his, dtype=np.uint64)
        smaxs = np.asarray(smaxs, dtype=np.uint64)
        smins = (np.zeros(len(los), dtype=np.uint64) if smins is None
                 else np.asarray(smins, dtype=np.uint64))
        for lo, hi, smax, smin in zip(los.tolist(), his.tolist(),
                                      smaxs.tolist(), smins.tolist()):
            self.insert(lo, hi, smax=smax, smin=smin)

    def flush(self) -> None:
        if self.buffer.size == 0:
            return
        with span("gloran.index_flush", n=self.buffer.size):
            areas = self.buffer.extract_all().sorted_by_lo()
            self.buffer.clear()
            self.io.write_sequential(len(areas) * 2 * self.config.key_size,
                                     tag="index_flush")
            self._push(0, areas)

    def _push(self, i: int, areas: AreaSet) -> None:
        while len(self.levels) <= i:
            self.levels.append(None)
        if self.levels[i] is None:
            self.levels[i] = (RTree.bulk_load(areas), areas)
        else:
            merged = self.levels[i][1].concat(areas).sorted_by_lo()
            self.io.read_sequential(
                (len(self.levels[i][1]) + len(areas)) * 2 *
                self.config.key_size, tag="index_compaction")
            self.io.write_sequential(len(merged) * 2 * self.config.key_size,
                                     tag="index_compaction")
            self.levels[i] = (RTree.bulk_load(merged), merged)
        if len(self.levels[i][1]) > self._level_capacity(i):
            _, overflow = self.levels[i]
            self.levels[i] = None
            self._push(i + 1, overflow)

    def covers(self, key: int, seq: int) -> bool:
        if self.buffer.size and self.buffer.covers(key, seq):
            return True
        hit = False
        for lvl in self.levels:
            if lvl is None:
                continue
            tree, _ = lvl
            v0 = tree.node_visits
            if tree.covers(key, seq):
                hit = True
            self.io.read_blocks(tree.node_visits - v0, tag="rtree_probe")
            if hit:
                break
        return hit

    def covers_batch(self, keys: np.ndarray, seqs: np.ndarray) -> np.ndarray:
        """Batched point stabbing across the buffer and every R-tree level.

        Each level descends once for the still-undecided queries (newest
        levels first, early-exiting covered queries like ``covers``), and
        charges the descent's node visits as random block I/Os — the
        overlap pathology stays visible in the ledger.
        """
        keys = np.asarray(keys, dtype=np.uint64)
        seqs = np.asarray(seqs, dtype=np.uint64)
        out = np.zeros(len(keys), dtype=bool)
        if len(keys) == 0:
            return out
        if self.buffer.size:
            out |= self.buffer.covers_batch(keys, seqs)
        for lvl in self.levels:
            if lvl is None:
                continue
            todo = ~out
            if not todo.any():
                break
            tree, _ = lvl
            v0 = tree.node_visits
            out[todo] = tree.covers_batch(keys[todo], seqs[todo])
            self.io.read_blocks(tree.node_visits - v0, tag="rtree_probe")
        return out

    @property
    def num_records(self) -> int:
        return self.buffer.size + sum(
            len(l[1]) for l in self.levels if l is not None)
