"""GLORAN facade: global range-delete manager = LSM-DRtree + EVE + GC.

This is what an LSM key-value store (``repro_torch.lsm.tree.LSMTree``) plugs in as
its range-delete strategy, and what the serving runtime uses for session
KV-state expiry.  Sequence numbers are supplied by the host store; the GC
floor is advanced by bottom-level compaction watermarks.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..obs import NULL_TRACER, span
from .eve import EVE, RAEConfig
from .iostats import IOStats
from .lsm_drtree import LSMDRTree, LSMDRTreeConfig, LSMRTree


@dataclass
class GloranConfig:
    index: LSMDRTreeConfig = field(default_factory=LSMDRTreeConfig)
    eve: RAEConfig | None = field(default_factory=RAEConfig)
    use_eve: bool = True
    use_drtree: bool = True  # False => GLORAN0 (LSM-Rtree levels)


class GloranIndex:
    """Global range-record index with the EVE predictive shortcut."""

    def __init__(self, config: GloranConfig | None = None,
                 io: IOStats | None = None):
        self.config = config or GloranConfig()
        self.io = io if io is not None else IOStats(
            block_size=self.config.index.block_size)
        if self.config.use_drtree:
            self.index = LSMDRTree(self.config.index, io=self.io)
        else:
            self.index = LSMRTree(self.config.index, io=self.io)
        self.eve = EVE(self.config.eve) if self.config.use_eve else None
        self.gc_floor = 0
        self.num_range_deletes = 0
        # Point-lookup validity counters (``is_deleted_batch(...,
        # count=True)``): entries probed, the part EVE could not prove
        # valid, and the part the index found deleted.  EVE has no false
        # negatives, so (eve_maybe - deleted) / (lookup_probes - deleted)
        # is its false-positive rate on valid entries.
        self.lookup_probes = 0
        self.eve_maybe = 0
        self.deleted = 0

    # ------------------------------------------------------------- writes
    def range_delete(self, lo: int, hi: int, seq: int) -> None:
        """Record a range delete over keys [lo, hi) issued at ``seq``.

        Its effective area is [lo, hi) x [0, seq): it invalidates ALL
        strictly older live entries (even ones below the GC floor — the
        floor only proves *already-applied* records' low coverage vacuous;
        a fresh delete must still kill old survivors).  GC later trims the
        floor up once this record has been applied by a bottom compaction.
        """
        assert lo < hi, "empty range"
        self.index.insert(lo, hi, smax=seq, smin=0)
        if self.eve is not None:
            self.eve.insert_range(lo, hi, seq)
        self.num_range_deletes += 1

    def range_delete_batch(self, los, his, seqs) -> None:
        """Record a batch of range deletes (one engine plan step).

        The whole batch lands columnar: the index's staging buffer
        absorbs it in vectorized appends chunked at the flush boundaries
        (``LSMDRTree.insert_batch`` — flush points, level shapes, and
        I/O charges identical to per-call inserts), and the EVE
        estimator absorbs it in chunked vectorized inserts (estimator
        bits and chain growth identical to issuing one by one).
        """
        los = np.asarray(los, dtype=np.uint64)
        his = np.asarray(his, dtype=np.uint64)
        seqs = np.asarray(seqs, dtype=np.uint64)
        assert (los < his).all(), "empty range"
        with span("gloran.index_insert", n=len(los)):
            self.index.insert_batch(los, his, smaxs=seqs)
        if self.eve is not None:
            with span("gloran.eve_insert", n=len(los)):
                self.eve.insert_range_batch(los, his, seqs)
        self.num_range_deletes += len(los)

    # ------------------------------------------------------------- reads
    def is_deleted(self, key: int, entry_seq: int) -> bool:
        """Is the entry (key, entry_seq) invalidated by a range delete?

        EVE fast path first: a negative estimator probe proves validity
        without touching the on-disk index (no false negatives).
        """
        if self.eve is not None and not self.eve.maybe_deleted(key,
                                                               entry_seq):
            return False
        return self.index.covers(key, entry_seq)

    def is_deleted_batch(self, keys: np.ndarray,
                         entry_seqs: np.ndarray,
                         query_fn=None, level_cov=None,
                         count: bool = False) -> np.ndarray:
        """Batched validity probe.  ``query_fn`` optionally replaces how
        individual LSM-DRtree levels are probed (see
        ``LSMDRTree.covers_batch``); ``level_cov`` optionally supplies
        the per-level verdicts wholesale — an (n, G) bool matrix from
        the fused cascade kernel, one column per non-None index level
        in order — and the index only replays charging/early-exit around
        them (``LSMDRTree.covers_batch_cov``).  Other index kinds ignore
        both.  The EVE fast path always runs first: proven-valid entries
        never touch the on-disk index either way.  ``count`` adds the
        probe to the point-lookup counters (``counters()``) and opens
        its ``gloran.eve`` / ``gloran.index_probe`` spans; the tree's
        point lookups set it, and compaction, scans and the scheduler
        do not, so their time stays under their own spans."""
        keys = np.asarray(keys, dtype=np.uint64)
        entry_seqs = np.asarray(entry_seqs, dtype=np.uint64)
        sub = span if count else NULL_TRACER.span
        if self.eve is not None:
            with sub("gloran.eve", n=len(keys)):
                maybe = self.eve.maybe_deleted_batch(keys, entry_seqs)
        else:
            maybe = np.ones(len(keys), dtype=bool)
        out = np.zeros(len(keys), dtype=bool)
        if maybe.any():
            km, sm = keys[maybe], entry_seqs[maybe]
            with sub("gloran.index_probe", n=len(km)):
                if level_cov is not None and isinstance(self.index,
                                                        LSMDRTree):
                    out[maybe] = self.index.covers_batch_cov(
                        km, sm, level_cov[maybe])
                elif query_fn is not None and isinstance(self.index,
                                                         LSMDRTree):
                    out[maybe] = self.index.covers_batch(km, sm,
                                                         query_fn=query_fn)
                elif hasattr(self.index, "covers_batch"):
                    out[maybe] = self.index.covers_batch(km, sm)
                else:
                    out[maybe] = [self.index.covers(int(k), int(s))
                                  for k, s in zip(km, sm)]
        if count:
            self.lookup_probes += len(keys)
            self.eve_maybe += int(maybe.sum())
            self.deleted += int(out.sum())
        return out

    def counters(self) -> dict:
        """The point-lookup validity counters (see ``__init__``)."""
        return {"lookup_probes": self.lookup_probes,
                "eve_maybe": self.eve_maybe, "deleted": self.deleted}

    # ---------------------------------------------------- device views
    @property
    def index_epoch(self) -> int | None:
        """Level-structure version of the on-disk index (None when the
        index kind keeps no epoch, e.g. the GLORAN0 R-tree baseline).
        Device-resident packed views of the disjoint interval levels
        cache on this value and rebuild whenever it moves."""
        return getattr(self.index, "epoch", None)

    def level_views(self) -> list | None:
        """The non-None on-disk index levels, newest -> oldest, or None
        when the index has no disjoint levels to export (GLORAN0).  Each
        entry is a ``DRTree`` whose canonical (lo, hi, smin, smax)
        arrays ARE the disjoint interval view the cascade kernel packs;
        order here defines the column order of ``level_cov``."""
        if not isinstance(self.index, LSMDRTree):
            return None
        return [lvl for lvl in self.index.levels if lvl is not None]

    def charge_range_scan(self, lo: int, hi: int,
                          block_size: int | None = None) -> None:
        """Charge the I/O of iterating the index for one range scan.

        A scan over [lo, hi) opens one iterator per on-disk index level
        and streams the (sorted, sequential) records overlapping the
        range: 1 seek plus ``cnt * 2k / B`` sequential block reads per
        level.  ``block_size`` defaults to the index's own block size;
        the host store passes its data block size so both ledgers use
        one unit.
        """
        bs = int(block_size) if block_size else self.config.index.block_size
        for lvl in getattr(self.index, "levels", []):
            if lvl is None:
                continue
            a = lvl.areas if hasattr(lvl, "areas") else None
            if a is None or len(a) == 0:
                continue
            i0 = int(np.searchsorted(a.hi, np.uint64(lo), side="right"))
            i1 = int(np.searchsorted(a.lo, np.uint64(hi)))
            cnt = max(0, i1 - i0)
            self.io.read_blocks(
                1 + (cnt * 2 * self.config.index.key_size) // bs,
                tag="gloran_scan")

    # ----------------------------------------------------------------- gc
    def on_bottom_compaction(self, watermark: int) -> None:
        """Event-listener hook (§4.4): a bottommost-level data compaction
        finished; every obsolete entry with seq < watermark is purged, so
        records/RAEs living entirely below it are vacuous."""
        if watermark <= self.gc_floor:
            return
        self.gc_floor = watermark
        if hasattr(self.index, "gc"):
            self.index.gc(watermark)
        if self.eve is not None:
            self.eve.gc(watermark)

    # ---------------------------------------------------------------- misc
    @property
    def memory_bytes(self) -> int:
        eve = self.eve.nbytes if self.eve is not None else 0
        buf = self.index.buffer
        if hasattr(buf, "model_bytes"):
            # Columnar staging buffer: raw records (all four key-sized
            # fields resident) plus its disjointized probe view.
            b = buf.model_bytes(self.config.index.key_size)
        else:
            # R-tree write buffer (GLORAN0 baseline): four key-sized
            # fields per record.
            b = buf.size * 4 * self.config.index.key_size
        return eve + b

    def buffer_snapshot(self) -> dict:
        """Staging-buffer occupancy (surfaced through ``EngineStats``)."""
        buf = self.index.buffer
        cap = self.config.index.buffer_capacity
        return {
            "records": int(buf.size),
            "capacity": int(cap),
            "occupancy": buf.size / cap if cap else 0.0,
            "view_records": int(getattr(buf, "view_records", 0)),
        }

    @property
    def disk_bytes(self) -> int:
        return getattr(self.index, "nbytes", 0)

    def stats(self) -> dict:
        return {
            "range_deletes": self.num_range_deletes,
            "records": self.index.num_records,
            "gc_floor": self.gc_floor,
            "memory_bytes": self.memory_bytes,
            "io": self.io.snapshot(),
        }
