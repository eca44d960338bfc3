"""LSM-tree key-value store with pluggable range-delete strategies.

Leveling configuration (one sorted run per level, size ratio T), following
§2: memtable of F entries, Bloom filter + fence pointers per run, point
tombstones, compaction cascades.  Range deletes dispatch to one of:

  decomp        tombstone per key in the range (the naive Delete loop)
  lookup_delete Get each key, Delete the ones that exist
  scan_delete   iterator scan, Delete found keys
  lrr           local range records: per-level range-tombstone blocks
                (RocksDB DeleteRange; the paper's SOTA baseline)
  gloran        this paper: global LSM-DRtree index + EVE

Every operation charges simulated block I/Os to ``self.io`` per the paper's
cost model; benchmarks report those counts alongside wall time.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from itertools import repeat

import numpy as np

from ..core.gloran import GloranConfig, GloranIndex
from ..core.iostats import IOStats
from ..obs import NULL_TRACER, span
from .format import LSMConfig, PUT, TOMBSTONE
from .merge import empty_run, merge_runs, merge_two, newest_wins
from .scheduler import FrozenMemtable
from .sstable import RangeTombstoneBlock, SSTable, build_sstable

STRATEGIES = ("decomp", "lookup_delete", "scan_delete", "lrr", "gloran")


@dataclass
class CascadeVerdict:
    """One fused-launch answer to a lookup batch's filter questions.

    Produced by an execution layer's ``cascade_fn`` hook (the engine's
    device-resident cascade kernel) and consumed by ``get_batch``'s
    mask-driven level loop: per packed level, Bloom verdicts, exact-key
    hits, and the candidate entry position whose block a surviving probe
    reads; plus (GLORAN only) per-index-level coverage of (key, resolved
    seq).  The tree replays its own control flow — unresolved-only
    probing, first-hit resolution, validity early-exit — around these
    verdicts, so results and I/O charges are identical to computing each
    stage on the host.
    """

    slots: np.ndarray          # tree level index -> packed column (-1 none)
    maybe: np.ndarray          # (n, L) bool: Bloom pass per packed level
    hit: np.ndarray            # (n, L) bool: exact key match per level
    pos: np.ndarray            # (n, L) int64: level-local candidate index
    gl_cov: np.ndarray | None  # (n, G) bool: GLORAN level coverage


class LSMTree:
    def __init__(self, config: LSMConfig | None = None,
                 strategy: str = "gloran",
                 gloran_config: GloranConfig | None = None):
        assert strategy in STRATEGIES, strategy
        self.config = config or LSMConfig()
        self.strategy = strategy
        self.io = IOStats(block_size=self.config.block_size)
        self.mem: dict[int, tuple[int, int, int]] = {}  # key->(seq,type,val)
        self._mem_snap = None  # cached sorted snapshot; None = stale
        self.mem_rts: list[tuple[int, int, int]] = []  # LRR buffer
        self._mem_rt_blk = None  # mem_rts as a block; None = stale
        self.levels: list[SSTable | None] = []
        self.level_rts: list[RangeTombstoneBlock] = []
        self.seq = 0
        self.gloran = None
        if strategy == "gloran":
            self.gloran = GloranIndex(gloran_config, io=self.io)
        self._sstable_seed = 0
        # Background mode (see lsm/scheduler.py): with a scheduler
        # attached, a full memtable SEALS into ``frozen`` (oldest first)
        # instead of flushing inline; reads serve active + frozen[] +
        # levels.  ``scheduler is None`` keeps the inline path
        # byte-identical — ``frozen`` stays empty and every guard below
        # short-circuits.
        self.frozen: list[FrozenMemtable] = []
        self.scheduler = None
        # Structural epoch + publish lock: every seal / level publish
        # bumps the epoch under the lock so out-of-band readers (stats,
        # registry views) can snapshot a consistent level set while a
        # drain point runs jobs on another thread.
        self.struct_epoch = 0
        self._struct_lock = threading.RLock()
        # Optional merge-rank hook for compactions (the engine installs
        # its gated CUDA merge-rank closure); None = host searchsorted.
        self.compaction_rank_fn = None
        # Per-level compaction observability (satellite of the
        # scheduler work): bytes moved compacting INTO each level and
        # range-tombstone bytes rewritten per level, surfaced as
        # ``lsm.compaction.bytes.L<i>`` / ``lsm.rt_compaction.bytes.L<i>``
        # in engine.stats().
        self.compaction_bytes: dict[int, int] = {}
        self.rt_compaction_bytes: dict[int, int] = {}

    # ------------------------------------------------------------ helpers
    def _next_seq(self) -> int:
        self.seq += 1
        return self.seq

    def _next_seqs(self, n: int) -> np.ndarray:
        out = np.arange(self.seq + 1, self.seq + n + 1, dtype=np.uint64)
        self.seq += n
        return out

    def _mem_put(self, key: int, seq: int, typ: int, val: int) -> None:
        self.mem[int(key)] = (int(seq), int(typ), int(val))
        self._mem_snap = None
        if len(self.mem) >= self.config.buffer_capacity:
            self.flush()

    # ------------------------------------------------------------- writes
    def put(self, key: int, val: int) -> None:
        self._mem_put(key, self._next_seq(), int(PUT), val)

    def put_batch(self, keys: np.ndarray, vals: np.ndarray) -> None:
        keys = np.asarray(keys, dtype=np.uint64)
        vals = np.asarray(vals, dtype=np.uint64)
        self._mem_insert_batch(keys, self._next_seqs(len(keys)),
                               int(PUT), vals)

    def delete(self, key: int) -> None:
        self._mem_put(key, self._next_seq(), int(TOMBSTONE), 0)

    def delete_batch(self, keys: np.ndarray) -> None:
        keys = np.asarray(keys, dtype=np.uint64)
        self._mem_insert_batch(keys, self._next_seqs(len(keys)),
                               int(TOMBSTONE), None)

    def _mem_insert_batch(self, keys: np.ndarray, seqs: np.ndarray,
                          typ: int, vals: np.ndarray | None) -> None:
        """Bulk memtable absorb, chunked at flush boundaries.

        Each chunk is one ``dict.update`` of at most the remaining
        buffer room, so the memtable can only reach capacity exactly at
        a chunk end: within a chunk the entry count grows by at most one
        per record and starts at least ``room`` below capacity, hence a
        per-record loop could not have flushed mid-chunk either.  Flush
        points (and therefore run shapes and I/O) are identical to
        per-record inserts; later duplicates win inside a chunk exactly
        as sequential overwrites would.
        """
        n = len(keys)
        kk = keys.tolist()
        ss = seqs.tolist()
        vv = vals.tolist() if vals is not None else None
        self._mem_snap = None
        at = 0
        while at < n:
            room = self.config.buffer_capacity - len(self.mem)
            take = min(max(room, 1), n - at)
            end = at + take
            payload = repeat(0, take) if vv is None else vv[at:end]
            self.mem.update(zip(kk[at:end],
                                zip(ss[at:end], repeat(typ, take),
                                    payload)))
            at = end
            if len(self.mem) >= self.config.buffer_capacity:
                self.flush()

    def range_delete(self, lo: int, hi: int) -> None:
        """Delete all keys in [lo, hi) using the configured strategy."""
        assert lo < hi
        if self.strategy == "decomp":
            self.delete_batch(np.arange(lo, hi, dtype=np.uint64))
        elif self.strategy == "lookup_delete":
            keys = np.arange(lo, hi, dtype=np.uint64)
            found, _ = self.get_batch(keys)
            if found.any():
                self.delete_batch(keys[found])
        elif self.strategy == "scan_delete":
            keys, _ = self.range_scan(lo, hi)
            if len(keys):
                self.delete_batch(keys)
        elif self.strategy == "lrr":
            self.mem_rts.append((int(lo), int(hi), self._next_seq()))
            self._mem_rt_blk = None
            # Range tombstones are memtable entries (RocksDB): they count
            # toward the buffer and flush with it.
            if len(self.mem) + len(self.mem_rts) >= \
                    self.config.buffer_capacity:
                self.flush()
        else:  # gloran
            self.gloran.range_delete(lo, hi, self._next_seq())

    def range_delete_batch(self, ranges) -> None:
        """Apply a batch of [lo, hi) range deletes in request order
        (tuple convenience over the columnar ``range_delete_arrays``)."""
        ranges = list(ranges)
        if not ranges:
            return
        self.range_delete_arrays(
            np.asarray([r[0] for r in ranges], dtype=np.uint64),
            np.asarray([r[1] for r in ranges], dtype=np.uint64))

    def range_delete_arrays(self, los: np.ndarray, his: np.ndarray) -> None:
        """Columnar batch range delete: two flat bound arrays, request
        order.

        Under GLORAN the whole batch stays columnar end-to-end — one
        call into the global index whose staging buffer absorbs it as
        vectorized appends (sequence numbers assigned in order, flush
        points identical to per-call deletes, estimator inserts
        vectorized); the other strategies apply their per-range write
        paths sequentially.
        """
        los = np.asarray(los, dtype=np.uint64)
        his = np.asarray(his, dtype=np.uint64)
        if len(los) == 0:
            return
        if self.strategy == "gloran":
            assert (los < his).all()
            self.gloran.range_delete_batch(los, his,
                                           self._next_seqs(len(los)))
        else:
            # Under LRR each range is a memtable tombstone; the seals and
            # flushes it triggers nest inside the span.
            sub = span if self.strategy == "lrr" else NULL_TRACER.span
            with sub("lsm.rt_insert", n=len(los)):
                for lo, hi in zip(los.tolist(), his.tolist()):
                    self.range_delete(int(lo), int(hi))

    # -------------------------------------------------------------- reads
    def get(self, key: int):
        """Point lookup; returns value or None."""
        key = int(key)
        rt_max = 0
        if self.strategy == "lrr":
            cov = np.zeros(1, dtype=np.uint64)
            self._fold_mem_rts(np.asarray([key], dtype=np.uint64), cov)
            rt_max = int(cov[0])
        hit = self.mem.get(key)
        if hit is not None:
            seq, typ, val = hit
            return self._resolve(key, seq, typ, val, rt_max)
        if self.frozen:
            # Sealed snapshots sit between the active memtable and the
            # levels: newest first, memory-resident (no I/O charge).
            for fz in reversed(self.frozen):
                if not len(fz.keys):
                    continue
                j = int(np.searchsorted(fz.keys, np.uint64(key)))
                if j < len(fz.keys) and fz.keys[j] == key:
                    return self._resolve(key, int(fz.seqs[j]),
                                         int(fz.types[j]),
                                         int(fz.vals[j]), rt_max)
        for i, lvl in enumerate(self.levels):
            if self.strategy == "lrr" and i < len(self.level_rts) and \
                    len(self.level_rts[i]):
                rt_max = max(rt_max, self.level_rts[i].probe(key, self.io))
            if lvl is None or len(lvl) == 0:
                continue
            found, seq, typ, val = lvl.get(key, self.io)
            if found:
                return self._resolve(key, seq, typ, val, rt_max)
        return None

    def _resolve(self, key, seq, typ, val, rt_max):
        if typ == TOMBSTONE:
            return None
        if self.strategy == "lrr" and rt_max > seq:
            return None
        if self.strategy == "gloran" and self.gloran.is_deleted(key, seq):
            return None
        return val

    def get_batch(self, keys: np.ndarray, *, cache=None, bloom_fn=None,
                  validity_fn=None, cascade_fn=None):
        """Vectorized point lookups. Returns (found_mask, values).

        Optional hooks let an execution layer swap HOW a stage computes
        without forking the read path (``repro_torch.engine`` uses these for
        its CUDA kernels and block cache): ``bloom_fn(sstable, keys)``
        supplies filter verdicts, ``cache`` absorbs data-block charges,
        ``validity_fn(keys, seqs, count=...)`` replaces the GLORAN
        validity probe (``GloranIndex.is_deleted_batch``'s signature:
        lookups count into its counters, scans do not),
        and ``cascade_fn(keys, resolved, seqs)`` answers EVERY level's
        filter questions in one fused launch (a ``CascadeVerdict``, or
        None to decline).  With a cascade verdict the level loop below
        only charges/reads data blocks for filter survivors — levels
        with zero survivors are skipped without being touched — and the
        GLORAN probe replays charging around the fused per-level
        coverage bits; results and I/O are identical either way.
        """
        keys = np.asarray(keys, dtype=np.uint64)
        n = len(keys)
        resolved = np.zeros(n, dtype=bool)
        out_found = np.zeros(n, dtype=bool)
        out_vals = np.zeros(n, dtype=np.uint64)
        out_seqs = np.zeros(n, dtype=np.uint64)
        rt_max = np.zeros(n, dtype=np.uint64)

        with span("lsm.get_mem", n=n):
            if self.strategy == "lrr":
                # ``built`` counts the tombstones whose block this fold
                # builds (0 where every block was cached).
                held = [(self.mem_rts, self._mem_rt_blk),
                        *((fz.rts, fz.rt_blk) for fz in self.frozen)]
                with span("lsm.rt_mem", n=n,
                          rts=sum(len(r) for r, _ in held),
                          built=sum(len(r) for r, b in held if b is None)):
                    self._fold_mem_rts(keys, rt_max)

            # Memtable: one sorted snapshot + batched binary search (skipped
            # entirely when empty — the steady post-flush state of
            # read-mostly serving).
            if self.mem:
                mk, ms, mt, mv = self._mem_sorted()
                j = np.minimum(np.searchsorted(mk, keys), len(mk) - 1)
                hitm = mk[j] == keys
                jh = j[hitm]
                resolved[hitm] = True
                out_found[hitm] = mt[jh] == PUT
                out_seqs[hitm] = ms[jh]
                out_vals[hitm] = mv[jh]

            # Sealed (frozen) memtables, newest first: memory-resident
            # sorted snapshots probed with the same batched binary search,
            # no I/O charge.
            if self.frozen:
                for fz in reversed(self.frozen):
                    if not len(fz.keys):
                        continue
                    todo = ~resolved
                    if not todo.any():
                        break
                    sub = keys[todo]
                    j = np.minimum(np.searchsorted(fz.keys, sub),
                                   len(fz.keys) - 1)
                    hitm = fz.keys[j] == sub
                    idx = np.flatnonzero(todo)[hitm]
                    jh = j[hitm]
                    resolved[idx] = True
                    out_found[idx] = fz.types[jh] == PUT
                    out_seqs[idx] = fz.seqs[jh]
                    out_vals[idx] = fz.vals[jh]

        # One fused launch answers bloom + fence + GLORAN for all
        # levels; the loop below replays resolution order around it.
        cas = None
        if cascade_fn is not None and not resolved.all():
            cas = cascade_fn(keys, resolved, out_seqs)

        with span("lsm.get_levels", n=n):
            for i, lvl in enumerate(self.levels):
                todo = ~resolved
                if not todo.any():
                    break
                if self.strategy == "lrr" and i < len(self.level_rts) and \
                        len(self.level_rts[i]):
                    blk = self.level_rts[i]
                    sub = keys[todo]
                    with span("lsm.rt_probe", n=len(sub), level=i,
                              rts=len(blk), rebuilt=int(not blk.built)):
                        rt_max[todo] = np.maximum(
                            rt_max[todo], blk.probe_batch(sub, self.io))
                if lvl is None or len(lvl) == 0:
                    continue
                if cas is not None:
                    sl = int(cas.slots[i])
                    maybe = cas.maybe[todo, sl]
                    if not maybe.any():
                        continue  # zero survivors: level skipped untouched
                    pos = cas.pos[todo, sl][maybe]
                    lvl.charge_probe(pos, self.io, cache=cache)
                    hitk = cas.hit[todo, sl][maybe]
                    sel = pos[hitk]
                    idx = np.flatnonzero(todo)[np.flatnonzero(maybe)[hitk]]
                    s, t, v = lvl.rows_at(sel)
                else:
                    sub = keys[todo]
                    f, s, t, v = lvl.get_batch(
                        sub, self.io, cache=cache,
                        maybe=bloom_fn(lvl, sub) if bloom_fn is not None
                        else None)
                    idx = np.flatnonzero(todo)[f]
                    s, t, v = s[f], t[f], v[f]
                resolved[idx] = True
                out_found[idx] = t == PUT
                out_seqs[idx] = s
                out_vals[idx] = v

        # Validity filtering.
        if self.strategy == "lrr":
            dead = out_found & (rt_max > out_seqs)
            out_found &= ~dead
        elif self.strategy == "gloran":
            cand = out_found
            if cand.any():
                ck, cs = keys[cand], out_seqs[cand]
                with span("gloran.validity", n=len(ck)):
                    if cas is not None and cas.gl_cov is not None:
                        dead = self.gloran.is_deleted_batch(
                            ck, cs, level_cov=cas.gl_cov[cand], count=True)
                    else:
                        is_dead = validity_fn or \
                            self.gloran.is_deleted_batch
                        dead = is_dead(ck, cs, count=True)
                sub = np.flatnonzero(cand)[dead]
                out_found[sub] = False
        return out_found, out_vals

    def _fold_mem_rts(self, keys: np.ndarray, rt_max: np.ndarray) -> None:
        """Fold the newest LRR tombstone of the memtable and the sealed
        memtables that covers each key into ``rt_max``: the one rule
        every LRR read (``get``, ``get_batch``, scans) takes for the
        memtables.  Seal boundaries are temporal, so folding every
        memtable up front is exact (an older tombstone can't outrank a
        newer entry).

        Each memtable answers through its own ``RangeTombstoneBlock``,
        probed uncharged (memtable tombstones are memory-resident): a
        max-seq step function built by the first read after its
        tombstones change, so a read burst between writes pays one
        ``searchsorted`` per memtable, not a pass per tombstone.
        """
        if self._mem_rt_blk is None:
            self._mem_rt_blk = RangeTombstoneBlock.from_tuples(
                self.mem_rts, self.config)
        blks = [self._mem_rt_blk]
        for fz in self.frozen:
            if fz.rt_blk is None:
                fz.rt_blk = RangeTombstoneBlock.from_tuples(fz.rts,
                                                            self.config)
            blks.append(fz.rt_blk)
        for blk in blks:
            np.maximum(rt_max, blk.max_covering_batch(keys), out=rt_max)

    def _mem_sorted(self):
        """Key-sorted snapshot of the memtable as a 4-array run, cached
        until the next memtable mutation so read bursts between writes
        (many lookup/scan batches against one buffered state) pay the
        O(m log m) sort once, not per batch."""
        if self._mem_snap is not None:
            return self._mem_snap
        m = len(self.mem)
        if m == 0:
            return empty_run()
        keys = np.fromiter(self.mem.keys(), np.uint64, m)
        rows = np.array(list(self.mem.values()), dtype=np.uint64)
        order = np.argsort(keys)
        self._mem_snap = (keys[order], rows[order, 0],
                          rows[order, 1].astype(np.uint8), rows[order, 2])
        return self._mem_snap

    def range_scan(self, lo: int, hi: int, *, validity_fn=None,
                   cache=None, rank_fn=None):
        """All live entries with lo <= key < hi. Returns (keys, vals)."""
        return self.range_scan_batch([(lo, hi)], validity_fn=validity_fn,
                                     cache=cache, rank_fn=rank_fn)[0]

    def range_scan_batch(self, ranges, *, validity_fn=None, cache=None,
                         rank_fn=None):
        """Execute many range scans in one pass over the tree.

        Each [lo, hi) produces the same (keys, vals) pair a per-call
        ``range_scan`` would, but the shared work is batched: the
        memtable is snapshotted/sorted once, per-level slice bounds and
        sequential-read charges are computed vectorized across all
        ranges, each range's slices are combined with a REMIX-style
        sorted-view merge (no per-scan lexsort), and LRR/GLORAN validity
        filtering runs once over the concatenated candidates of every
        range.  ``validity_fn(keys, seqs) -> dead mask`` optionally
        replaces the GLORAN probe (``repro_torch.engine`` supplies the CUDA
        interval-kernel path), exactly like ``get_batch``; ``cache``
        optionally absorbs the data-block charges of each level's slices
        (scan-resident blocks stop paying I/O, see
        ``SSTable.range_slice_many``); ``rank_fn`` optionally replaces
        how each two-way merge round computes output positions
        (``repro_torch.engine`` supplies the CUDA merge-rank kernel — see
        ``lsm.merge.merge_two``).
        """
        ranges = [(int(lo), int(hi)) for lo, hi in ranges]
        nr = len(ranges)
        if nr == 0:
            return []
        los = np.array([r[0] for r in ranges], dtype=np.uint64)
        his = np.array([r[1] for r in ranges], dtype=np.uint64)
        mem = self._mem_sorted()
        m_lo = np.searchsorted(mem[0], los)
        m_hi = np.searchsorted(mem[0], his)
        # Frozen snapshots contribute one memory-resident slice each
        # (no I/O, like the active memtable); newest_wins resolves
        # versions by seq, so part order is immaterial.
        per_frozen = [(fz, np.searchsorted(fz.keys, los),
                       np.searchsorted(fz.keys, his))
                      for fz in self.frozen if len(fz.keys)]
        per_level = [lvl.range_slice_many(los, his, self.io, cache=cache)
                     for lvl in self.levels
                     if lvl is not None and len(lvl)]
        merged = []
        for j in range(nr):
            parts = [tuple(x[m_lo[j]:m_hi[j]] for x in mem)]
            parts += [(fz.keys[a[j]:b[j]], fz.seqs[a[j]:b[j]],
                       fz.types[a[j]:b[j]], fz.vals[a[j]:b[j]])
                      for fz, a, b in per_frozen]
            parts += [slices[j] for slices in per_level]
            merged.append(newest_wins(*merge_runs(parts, rank_fn=rank_fn)))
        live = [m[2] == PUT for m in merged]
        # Validity filtering, batched across every non-empty range.
        nz = [j for j in range(nr) if len(merged[j][0])]
        if nz and self.strategy in ("lrr", "gloran"):
            cat_keys = np.concatenate([merged[j][0] for j in nz])
            cat_seqs = np.concatenate([merged[j][1] for j in nz])
            if self.strategy == "lrr":
                dead = self._lrr_scan_dead(cat_keys, cat_seqs, his[nz])
            else:
                for j in nz:
                    # Iterators over each index level stream the areas
                    # overlapping the scan range (sorted + sequential).
                    self.gloran.charge_range_scan(
                        ranges[j][0], ranges[j][1], self.config.block_size)
                is_dead = validity_fn or self.gloran.is_deleted_batch
                dead = is_dead(cat_keys, cat_seqs)
            off = 0
            for j in nz:
                n = len(merged[j][0])
                live[j] &= ~dead[off:off + n]
                off += n
        return [(m[0][lv], m[3][lv]) for m, lv in zip(merged, live)]

    def _lrr_scan_dead(self, keys: np.ndarray, seqs: np.ndarray,
                       his: np.ndarray) -> np.ndarray:
        """Max-covering range-tombstone filter for scan candidates.

        ``his`` holds the scan upper bounds (one per range) so each
        level's tombstone-iterator charge — a sequential stream of the
        tombstones with start < hi, per range — matches the per-call
        path exactly.
        """
        rt_max = np.zeros(len(keys), dtype=np.uint64)
        self._fold_mem_rts(keys, rt_max)  # memory-resident: no charge
        for rtb in self.level_rts:
            if len(rtb):
                cnts = np.searchsorted(rtb.starts, his)
                self.io.read_blocks(
                    int((1 + (cnts * self.config.range_tombstone_size) //
                         self.config.block_size).sum()), tag="rt_scan")
                rt_max = np.maximum(rt_max, rtb.max_covering_batch(keys))
        return rt_max > seqs

    # -------------------------------------------------- flush / compaction
    def flush(self) -> None:
        if not self.mem and not self.mem_rts:
            return
        if self.scheduler is not None:
            # Background mode: seal (cheap — the cached columnar
            # snapshot) and let the scheduler flush/compact at the next
            # drain point.  The foreground thread never pays the
            # cascade unless the frozen soft limit backpressures.
            self._seal()
            return
        with span("lsm.flush", entries=len(self.mem),
                  range_tombstones=len(self.mem_rts)):
            self._flush()

    def _seal(self) -> None:
        """Freeze the active memtable (and LRR buffer) into an
        immutable snapshot served by reads until a background flush
        job publishes it as a level-0 run."""
        with span("lsm.seal", entries=len(self.mem),
                  range_tombstones=len(self.mem_rts),
                  backlog=len(self.frozen)):
            mk, ms, mt, mv = self._mem_sorted()
            with self._struct_lock:
                self.frozen.append(FrozenMemtable(mk, ms, mt, mv,
                                                  self.mem_rts))
                self.mem = {}
                self._mem_snap = None
                self.mem_rts = []
                self._mem_rt_blk = None
                self.struct_epoch += 1
        self.scheduler.on_seal()

    def _flush_frozen_one(self) -> None:
        """Background flush job body: publish the oldest frozen
        snapshot as a level-0 run with exactly the inline ``_flush``
        charges (the snapshot holds the same sorted-unique rows the
        inline path would lexsort, so the run — bloom bits included —
        is byte-identical).  Capacity cascades are the scheduler's
        follow-up jobs, not run here."""
        with self._struct_lock:
            if not self.frozen:
                return
            fz = self.frozen.pop(0)
            self.struct_epoch += 1
        if len(fz.keys):
            self._sstable_seed += 1
            run = build_sstable(fz.keys, fz.seqs, fz.types, fz.vals,
                                self.config, io=self.io,
                                seed=self._sstable_seed, presorted=True)
            self._merge_into(0, run)
        if self.strategy == "lrr" and fz.rts:
            # The block a get built keeps its step function for the merge.
            rtb = fz.rt_blk if fz.rt_blk is not None else \
                RangeTombstoneBlock.from_tuples(fz.rts, self.config)
            self._ensure_rt(0)
            self.level_rts[0] = self.level_rts[0].merge(rtb)
            self.io.write_sequential(self.level_rts[0].nbytes,
                                     tag="rt_flush")

    def _flush(self) -> None:
        if self.mem:
            # The cached sorted columnar snapshot IS the run content:
            # unique keys (dict semantics), key-sorted — no per-entry
            # python loop, no lexsort in build_sstable (presorted).
            mk, ms, mt, mv = self._mem_sorted()
            self.mem.clear()
            self._mem_snap = None
            self._sstable_seed += 1
            run = build_sstable(mk, ms, mt, mv, self.config, io=self.io,
                                seed=self._sstable_seed, presorted=True)
            self._merge_into(0, run)
        if self.strategy == "lrr" and self.mem_rts:
            rtb = self._mem_rt_blk if self._mem_rt_blk is not None else \
                RangeTombstoneBlock.from_tuples(self.mem_rts, self.config)
            self.mem_rts = []
            self._mem_rt_blk = None
            self._ensure_rt(0)
            self.level_rts[0] = self.level_rts[0].merge(rtb)
            self.io.write_sequential(self.level_rts[0].nbytes, tag="rt_flush")
        self._cascade()

    def _ensure_rt(self, i: int) -> None:
        while len(self.level_rts) <= i:
            self.level_rts.append(RangeTombstoneBlock.empty(self.config))

    def _merge_rows(self, a: tuple, b: tuple) -> tuple:
        """Key-ordered union of two sorted runs (cross-run duplicates
        adjacent), with output positions through the engine's gated
        merge-rank kernel hook when installed — bit-identical to the
        host searchsorted pair, and (after the presorted newest-wins
        dedup in ``build_sstable``) to the legacy concatenate+lexsort."""
        return merge_two(a, b, rank_fn=self.compaction_rank_fn)

    def _publish_level(self, i: int, run: SSTable | None) -> None:
        """Atomically install a level's new run (epoch bump under the
        structure lock, so concurrent snapshot readers never observe a
        half-applied compaction)."""
        with self._struct_lock:
            self.levels[i] = run
            self.struct_epoch += 1

    def _track_compaction(self, i: int, nbytes: int) -> None:
        self.compaction_bytes[i] = self.compaction_bytes.get(i, 0) + \
            int(nbytes)

    def _merge_into(self, i: int, run: SSTable) -> None:
        while len(self.levels) <= i:
            self.levels.append(None)
        self._ensure_rt(i)
        if self.levels[i] is None or len(self.levels[i]) == 0:
            self._publish_level(i, run)
            return
        dst = self.levels[i]
        self.io.read_sequential(dst.nbytes + run.nbytes, tag="compaction")
        self._track_compaction(i, dst.nbytes + run.nbytes)
        keys, seqs, typs, vals = self._merge_rows(
            (run.keys, run.seqs, run.types, run.vals),
            (dst.keys, dst.seqs, dst.types, dst.vals))
        self._sstable_seed += 1
        merged = build_sstable(keys, seqs, typs, vals, self.config,
                               io=self.io, seed=self._sstable_seed,
                               presorted=True)
        self._publish_level(i, merged)

    def _is_bottom(self, i: int) -> bool:
        return all(self.levels[j] is None or len(self.levels[j]) == 0
                   for j in range(i + 1, len(self.levels)))

    def _cascade(self) -> None:
        i = 0
        while i < len(self.levels):
            lvl = self.levels[i]
            if lvl is not None and len(lvl) > self.config.level_capacity(i):
                self._compact(i)
            i += 1

    def _compact(self, i: int) -> None:
        """Merge level i into level i+1 (leveling)."""
        with span("lsm.compact", level=i, entries=len(self.levels[i])):
            self._compact_impl(i)

    def _compact_impl(self, i: int) -> None:
        src = self.levels[i]
        self._publish_level(i, None)
        while len(self.levels) <= i + 1:
            self.levels.append(None)
        self._ensure_rt(i + 1)
        dst = self.levels[i + 1]
        self.io.read_sequential(
            src.nbytes + (dst.nbytes if dst is not None else 0),
            tag="compaction")
        self._track_compaction(
            i + 1, src.nbytes + (dst.nbytes if dst is not None else 0))
        # Key-ordered union through the merge-rank path (kernel-gated);
        # duplicates stay adjacent for the presorted newest-wins dedup
        # in build_sstable — the delete masks below see the same rows
        # (elementwise) the legacy concatenate order did.
        if dst is not None and len(dst):
            keys, seqs, typs, vals = self._merge_rows(
                (src.keys, src.seqs, src.types, src.vals),
                (dst.keys, dst.seqs, dst.types, dst.vals))
        else:
            keys, seqs, typs, vals = (src.keys, src.seqs, src.types,
                                      src.vals)
        bottom = self._is_bottom(i + 1)
        if self.strategy == "lrr":
            rtb = self.level_rts[i].merge(self.level_rts[i + 1])
            self.level_rts[i] = RangeTombstoneBlock.empty(self.config)
            if len(rtb):
                self.io.read_sequential(rtb.nbytes, tag="rt_compaction")
                self.rt_compaction_bytes[i + 1] = \
                    self.rt_compaction_bytes.get(i + 1, 0) + rtb.nbytes
                cov = rtb.max_covering_batch(keys)
                keep = ~(cov > seqs)
                keys, seqs, typs, vals = (keys[keep], seqs[keep], typs[keep],
                                          vals[keep])
            if bottom:
                # Range tombstones expire at the bottommost level.
                self.level_rts[i + 1] = RangeTombstoneBlock.empty(self.config)
            else:
                self.level_rts[i + 1] = rtb
                self.io.write_sequential(rtb.nbytes, tag="rt_compaction")
                if len(rtb):
                    self.rt_compaction_bytes[i + 1] = \
                        self.rt_compaction_bytes.get(i + 1, 0) + rtb.nbytes
        elif self.strategy == "gloran" and self.gloran is not None and bottom:
            # Stream-merge against the global index: one sequential pass.
            idx = self.gloran.index
            for lvl in getattr(idx, "levels", []):
                if lvl is not None and hasattr(lvl, "scan_io"):
                    self.io.read_blocks(lvl.scan_io(), tag="gloran_compact")
            dead = self.gloran.is_deleted_batch(keys, seqs)
            keep = ~dead
            keys, seqs, typs, vals = (keys[keep], seqs[keep], typs[keep],
                                      vals[keep])
        self._sstable_seed += 1
        merged = build_sstable(keys, seqs, typs, vals, self.config,
                               io=self.io, seed=self._sstable_seed,
                               presorted=True)
        if bottom and len(merged):
            # Point tombstones expire at the bottommost level.
            keep = merged.types != TOMBSTONE
            if not keep.all():
                self._sstable_seed += 1
                merged = build_sstable(merged.keys[keep], merged.seqs[keep],
                                       merged.types[keep], merged.vals[keep],
                                       self.config, io=None,
                                       seed=self._sstable_seed,
                                       presorted=True)
        self._publish_level(i + 1, merged)
        if self.strategy == "gloran" and bottom:
            # GC watermark: everything below it now lives in the bottom
            # level and has had range deletes applied.
            self.gloran.on_bottom_compaction(self._watermark(i + 1))

    def _watermark(self, bottom_idx: int) -> int:
        w = self.seq
        if self.mem:
            w = min(w, min(s for s, _, _ in self.mem.values()))
        for fz in self.frozen:
            # Sealed-but-unflushed entries are above the bottom level:
            # they hold the GC floor down exactly like the memtable.
            if len(fz.seqs):
                w = min(w, fz.min_seq)
        for j in range(bottom_idx):
            lvl = self.levels[j]
            if lvl is not None and len(lvl):
                w = min(w, lvl.min_seq)
        return w

    # ---------------------------------------------------------------- misc
    @property
    def num_entries(self) -> int:
        return len(self.mem) + sum(len(f) for f in self.frozen) + sum(
            len(l) for l in self.levels if l is not None)

    @property
    def disk_bytes(self) -> int:
        data = sum(l.nbytes for l in self.levels if l is not None)
        rt = sum(r.nbytes for r in self.level_rts)
        idx = self.gloran.disk_bytes if self.gloran else 0
        return data + rt + idx

    @property
    def memory_bytes(self) -> int:
        mem = (len(self.mem) + sum(len(f) for f in self.frozen)) * \
            self.config.entry_size
        blooms = sum(l.bloom.nbytes for l in self.levels if l is not None)
        fences = sum(
            l.data_blocks() * self.config.key_size
            for l in self.levels if l is not None)
        g = self.gloran.memory_bytes if self.gloran else 0
        return mem + blooms + fences + g

    def stats(self) -> dict:
        return {
            "entries": self.num_entries,
            "levels": [len(l) if l is not None else 0 for l in self.levels],
            "frozen": [len(f) for f in self.frozen],
            "struct_epoch": self.struct_epoch,
            "seq": self.seq,
            "disk_bytes": self.disk_bytes,
            "memory_bytes": self.memory_bytes,
            "io": self.io.snapshot(),
        }
