"""Per-shard batched execution with the CUDA filter stage.

``ShardExecutor`` owns one ``LSMTree`` and drives its canonical batched
read path (``LSMTree.get_batch``) with hooks swapped in:

  cascade_fn   THE preferred read path: one fused launch of the
               ``repro_torch.kernels.cascade`` kernel answers every
               level's Bloom + fence questions and the GLORAN per-level
               interval verdicts from persistent device state (the
               shard's ``DeviceFilterRegistry`` — uploaded once per
               SSTable / index epoch, invalidated on compaction).  Gated
               by ``kernel_min_batch``, u32 eligibility and the pack
               budgets; when it declines, the per-level hooks below
               serve the lookup instead, with identical results and I/O
               charges,
  bloom_fn     SSTable filter probes through the ``kernels.bloom``
               kernel (bit-exact with ``BloomBits.might_contain``) once
               the sub-batch and filter are big enough to pay for a
               launch,
  cache        data-block reads charged through the shard's read-through
               ``BlockCache`` so hot blocks stop costing I/O,
  validity_fn  GLORAN validity probing where each LSM-DRtree level is
               queried with one ``interval_query`` launch instead of a
               per-key ``covers`` descent — the disjoint level arrays
               are clamped into u32 working space (exact for u32-range
               queries).

Range scans run the tree's one-pass ``range_scan_batch`` with the same
``validity_fn`` (GLORAN validity of every scan candidate, one
``interval_query`` launch a DR-tree level when gated in), the block
cache, and ``rank_fn``: each two-way merge round of a scan's sorted
views takes its output positions from the ``kernels.merge`` merge-rank
kernel once the round is big enough to pay for a launch.  Compactions
order their two-run merges through the same hook
(``compaction_rank_fn``), bit-exact with the host searchsorted pair —
inline, or as background jobs of an attached ``CompactionScheduler``
drained at the start of every plan.

Durable shards (``attach_durability``) append one WAL frame per plan —
every write op of the plan, before any step runs — and commit a
manifest edit whenever a plan, a background job or an explicit flush
moved the level structure.

The control flow stays single-sourced in ``LSMTree`` / ``GloranIndex`` /
``LSMDRTree``; hooks only replace HOW a verdict is computed, never what
is charged for it — except the block cache, whose whole point is
skipping charges for resident blocks.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from functools import partial

import numpy as np

from ..core.eve import fold64to32
from ..device import on_device, resolve_device
# Submodule imports (not the package) keep the engine <-> durable import
# graph acyclic; durable.manifest depends only on durable.atomic.
from ..durable.manifest import structure_fingerprint
from ..durable.wal import FRAME_BATCH, FSYNC_POLICIES
from ..kernels.bloom.ops import bloom_probe
from ..kernels.cascade.ops import cascade_lookup
from ..kernels.interval.ops import interval_query
from ..kernels.merge.ops import merge_ranks
from ..kernels.u32 import to_device, to_numpy
from ..lsm.scheduler import level_rt_density
from ..lsm.tree import CascadeVerdict, LSMTree
from ..obs import span
from .cache import BlockCache
from .plan import (KIND_NAMES, OP_DELETE, OP_GET, OP_PUT, OP_RANGE_DELETE,
                   OP_RANGE_SCAN, ShardPlan)
from .registry import DeviceFilterRegistry, _U32_LIMIT
from .stats import KernelCounters


@dataclass
class EngineConfig:
    """Knobs of the batched execution layer (not the LSM itself)."""

    device: str = "cuda"  # torch device of every shard's state + kernels
    # Per-shard home devices (``device.shard_devices``): None = auto
    # (every shard on ``device`` where at most one card is visible, else
    # round-robin over up to ``num_shards`` cards); 0 = every shard on
    # ``device``; N = round-robin over cuda:0 .. cuda:min(N, count) - 1.
    # With ``device="cpu"`` every shard is on the CPU.
    devices: int | None = None
    partition: str = "hash"  # "hash" | "range" key partitioning
    pipeline: bool = True  # concurrent shard plans
    cache_blocks: int = 0  # per-shard block cache capacity; 0 = off
    use_bloom_kernel: bool = True
    use_interval_kernel: bool = True
    use_merge_kernel: bool = True
    use_cascade_kernel: bool = True  # fused all-levels lookup cascade
    kernel_min_batch: int = 256  # sub-batch size worth a kernel launch
    kernel_min_areas: int = 64  # DR-tree level size worth a launch
    kernel_min_filter: int = 512  # SSTable entries worth a launch
    kernel_min_merge: int = 1024  # total keys in a 2-way merge round
    # Timed-I/O mode: seconds a shard worker sleeps per simulated I/O
    # block its plan step charged (0.0 = off: I/O stays count-only).
    # With it on, measured wall includes the store's modeled device
    # waits, and those waits overlap across pipelined shard workers
    # (sleep releases the GIL) as concurrent NVMe queues would.
    io_wait_s: float = 0.0
    # Background delete-aware compaction (lsm/scheduler.py); off is the
    # inline flush path.  With it on, a full memtable seals into an
    # immutable snapshot and flush + cascade run as background jobs at
    # the deterministic drain points, byte-identical to inline.  Like
    # ``pipeline``, the default is this field's: no environment
    # variable is read.
    scheduler: bool = False
    # Soft limit on sealed-but-unflushed memtables per shard; sealing
    # past it backpressures (runs due jobs on the sealing thread,
    # counted as a stall).
    max_frozen: int = 4
    # Lethe-style proactive compaction trigger: a level whose estimated
    # range-tombstone density reaches this fraction is compacted down
    # ahead of overflow (None = capacity-driven only; proactive
    # compaction intentionally diverges from the inline level shapes to
    # reclaim GLORAN garbage early).  Needs ``scheduler``.
    tombstone_trigger: float | None = None
    # Durability: a WAL directory turns on per-shard write-ahead logging
    # plus the level manifest (see ``repro_torch.durable``).  Batches
    # are acknowledged only after their write ops are appended (and,
    # under the "batch" policy, fsynced).  ``fsync`` is one of "batch" |
    # "rotate" | "never" (see ``durable.wal.FSYNC_POLICIES``).
    wal_dir: str | None = None
    fsync: str = "batch"
    wal_segment_bytes: int = 4 << 20
    # Process-parallel shard execution (``engine/procpool.py``): None or
    # 0 = in-process; N spawns min(N, num_shards) worker processes, each
    # with its own CUDA context, shards assigned round-robin and shard
    # plans shipped as shared-memory columnar frames.  No environment
    # variable is read.
    procs: int | None = None
    # Capacity of each per-direction shared-memory transport ring.
    proc_ring_bytes: int = 32 << 20

    def __post_init__(self) -> None:
        if self.fsync not in FSYNC_POLICIES:
            raise ValueError(f"EngineConfig.fsync={self.fsync!r}: one of "
                             f"{FSYNC_POLICIES}")
        resolve_device(self.device)  # raises where CUDA is absent


class ShardExecutor:
    def __init__(self, tree: LSMTree, config: EngineConfig, device):
        self.tree = tree
        self.config = config
        self.device = device
        self.cache = BlockCache(self.config.cache_blocks)
        self.kernels = KernelCounters()
        # Device-resident packed filter state for the fused cascade AND
        # the per-level kernel route (per-SSTable pieces + GLORAN
        # interval views, structurally invalidated).
        self.registry = DeviceFilterRegistry(device, self.kernels)
        # Durability attachments (None = volatile shard; see
        # ``Engine._attach_durability`` / ``repro_torch.durable``).  The
        # WAL writer is single-appender by construction: all appends
        # happen on this shard's pipeline thread (or the engine thread
        # after a drain), the existing per-shard FIFO.
        self.wal = None
        self.manifest = None
        self.shard_id = 0
        # Background compaction scheduler (None = inline flush path).
        self.scheduler = None
        # Compactions route their two-run merge through the gated
        # merge-rank kernel closure (the same hook the scans use).
        tree.compaction_rank_fn = self._rank_fn()

    def attach_durability(self, wal, manifest, shard_id: int) -> None:
        self.wal = wal
        self.manifest = manifest
        self.shard_id = int(shard_id)

    def attach_scheduler(self, scheduler) -> None:
        """Enable background mode: the tree seals instead of flushing
        inline, and this executor drains the job queue at every plan
        start / explicit flush (the deterministic points that keep
        results byte-identical to the inline path)."""
        self.scheduler = scheduler
        self.tree.scheduler = scheduler
        self.tree.io.enable_locking()

    def run_scheduler(self, reason: str = "sched") -> None:
        """Drain due background jobs (flushes, cascades, proactive
        compactions) on the calling thread, committing a manifest edit
        if the level structure moved (jobs mutate structure outside any
        plan, exactly like an explicit flush)."""
        if self.scheduler is None or not self.scheduler.has_work():
            return
        fp0 = (structure_fingerprint(self.tree)
               if self.manifest is not None else None)
        self.scheduler.run_due()
        self._maybe_record_structure(fp0, reason)

    def _log_plan(self, sp: ShardPlan) -> None:
        """Group commit: ONE WAL frame holding every write op of this
        shard plan (reads are not logged — replay re-derives any reads
        embedded in delete strategies from the rebuilt state).  Under
        the "batch" fsync policy the frame is durable before any step
        executes, so acknowledgement (which follows ``run_plan``)
        implies durability."""
        kinds, keys, vals, los, his = [], [], [], [], []
        for step in sp.steps:
            if step.kind not in (OP_PUT, OP_DELETE, OP_RANGE_DELETE):
                continue
            if step.kind == OP_RANGE_DELETE:
                n = len(step.los)
                z = np.zeros(n, np.uint64)
                keys.append(z)
                vals.append(z)
                los.append(step.los)
                his.append(step.his)
            else:
                n = len(step.keys)
                z = np.zeros(n, np.uint64)
                keys.append(step.keys)
                vals.append(step.vals if step.kind == OP_PUT else z)
                los.append(z)
                his.append(z)
            kinds.append(np.full(n, step.kind, np.uint8))
        if not kinds:
            return
        self.wal.append(FRAME_BATCH, sp.seq, np.concatenate(kinds),
                        np.concatenate(keys), np.concatenate(vals),
                        np.concatenate(los), np.concatenate(his))

    def _maybe_record_structure(self, fp0, reason: str) -> None:
        """Commit a manifest edit iff the durable structure moved."""
        if self.manifest is None:
            return
        if structure_fingerprint(self.tree) != fp0:
            self.manifest.record_structure(self.shard_id, self.tree,
                                           reason=reason)

    # ----------------------------------------------------------- writes
    def put_batch(self, keys: np.ndarray, vals: np.ndarray) -> None:
        """Insert a batch of (key, val) pairs into the shard's tree."""
        self.tree.put_batch(keys, vals)

    def delete_batch(self, keys: np.ndarray) -> None:
        """Point-delete a batch of keys (one tombstone each)."""
        self.tree.delete_batch(keys)

    def range_delete(self, lo: int, hi: int) -> None:
        """Delete [lo, hi) via the tree's configured strategy."""
        self.tree.range_delete(lo, hi)

    def range_delete_batch(self, ranges) -> None:
        """Apply a batch of [lo, hi) range deletes in request order
        (GLORAN absorbs the batch in one index/estimator call)."""
        self.tree.range_delete_batch(ranges)

    def range_delete_arrays(self, los: np.ndarray, his: np.ndarray) -> None:
        """Columnar batch range delete: the plan step's clipped bound
        arrays go straight into the tree (no tuple round trip)."""
        self.tree.range_delete_arrays(los, his)

    def flush(self) -> None:
        """Flush the shard's memtable (and LRR buffer) to level 0; with
        a scheduler, synchronously: the sealed snapshot and every job
        it queues have run when this returns.

        Durable shards first log a FLUSH marker — the flush mutates
        level structure outside any plan, and replay must flush at the
        same point for level shapes to come back byte-identical — and
        commit a manifest edit if the level stack moved."""
        if self.wal is not None:
            self.wal.append_flush()
        fp0 = (structure_fingerprint(self.tree)
               if self.manifest is not None else None)
        self.tree.flush()
        if self.scheduler is not None:
            # Explicit flush is synchronous: the FLUSH frame above acks
            # only after the background flush durably published.
            self.scheduler.drain()
        self._maybe_record_structure(fp0, "flush")

    # ------------------------------------------------ uniform surface
    @property
    def io_reads(self) -> int:
        return self.tree.io.reads

    @property
    def io_writes(self) -> int:
        return self.tree.io.writes

    @property
    def num_entries(self) -> int:
        return self.tree.num_entries

    def cache_snapshot(self) -> dict:
        return self.cache.snapshot()

    def stats_full(self) -> dict:
        """Every per-shard ledger ``engine.stats()`` rolls up, in one
        JSON-able document."""
        tree = self.tree
        return {
            "io": tree.io.snapshot(),
            "entries": int(tree.num_entries),
            "kernels": self.kernels.snapshot(),
            "cache": self.cache.snapshot(),
            "staging": (tree.gloran.buffer_snapshot()
                        if tree.gloran is not None else None),
            "sched": (self.scheduler.counters()
                      if self.scheduler is not None else None),
            "wal": self.wal.counters() if self.wal is not None else None,
            "gloran": (tree.gloran.counters()
                       if tree.gloran is not None else None),
            "lsm": {
                "compaction_bytes": {int(i): int(b) for i, b in
                                     tree.compaction_bytes.items()},
                "rt_compaction_bytes": {int(i): int(b) for i, b in
                                        tree.rt_compaction_bytes.items()},
                "rt_density": {i: round(level_rt_density(tree, i), 4)
                               for i in range(len(tree.levels))},
                "num_levels": len(tree.levels),
            },
        }

    def close(self) -> None:
        if self.wal is not None:
            self.wal.close()

    # ------------------------------------------------------- typed plans
    def run_plan(self, sp: ShardPlan) -> tuple[list, float]:
        """Execute one compiled ``ShardPlan`` in request order.

        Each ``PlanStep`` is one vectorized sub-batch on this shard's
        batched paths.  Returns ``(payloads, wall_seconds)`` where
        payloads carry the result-bearing steps — ``(OP_GET, idx, found,
        vals)`` and ``(OP_RANGE_SCAN, idx, [(keys, vals), ...])`` — for
        the engine's deterministic merge-back; ``wall_seconds`` is this
        shard's busy time.  Thread-safe across shards: every touched
        structure (tree, cache, counters, I/O ledger) is shard-local.
        """
        t0 = time.perf_counter()
        payloads: list = []
        io_wait = self.config.io_wait_s
        with span("shard.plan", shard=sp.shard, batch=sp.seq,
                  steps=len(sp.steps), n_ops=sp.n_ops,
                  device=str(self.device)):
            # The WAL append comes first, before the scheduler drain:
            # replay drains at the start of each frame, so a frame must
            # stand for the writes that followed this drain point.
            if self.wal is not None:
                with span("shard.wal_append", shard=sp.shard,
                          batch=sp.seq):
                    self._log_plan(sp)
            # Background jobs drain BEFORE the plan's steps: every plan
            # starts from the fully-caught-up state the inline path
            # would have reached, which keeps cross-plan results, level
            # shapes and I/O ledgers byte-identical with the scheduler
            # on.
            self.run_scheduler()
            fp0 = (structure_fingerprint(self.tree)
                   if self.manifest is not None else None)
            for step in sp.steps:
                with span("shard." + KIND_NAMES[step.kind], n=len(step),
                          shard=sp.shard, batch=sp.seq):
                    io0 = self.tree.io.total if io_wait > 0.0 else 0
                    if step.kind == OP_PUT:
                        self.put_batch(step.keys, step.vals)
                    elif step.kind == OP_DELETE:
                        self.delete_batch(step.keys)
                    elif step.kind == OP_GET:
                        found, vals = self.get_batch(step.keys)
                        payloads.append((OP_GET, step.idx, found, vals))
                    elif step.kind == OP_RANGE_SCAN:
                        res = self.range_scan_batch(
                            list(zip(step.los.tolist(),
                                     step.his.tolist())))
                        payloads.append((OP_RANGE_SCAN, step.idx, res))
                    else:  # OP_RANGE_DELETE (bounds clipped per shard)
                        self.range_delete_arrays(step.los, step.his)
                    if io_wait > 0.0:
                        # Timed-I/O mode: serve the step's charged
                        # blocks as a real wait.  Charges are untouched;
                        # only wall time grows, and it overlaps across
                        # shard workers (sleep releases the GIL).
                        dio = self.tree.io.total - io0
                        if dio:
                            time.sleep(dio * io_wait)
            self._maybe_record_structure(fp0, "plan")
        return payloads, time.perf_counter() - t0

    # ------------------------------------------------------------ reads
    def _validity_fn(self):
        """The GLORAN validity hook: batched ``is_deleted`` verdicts with
        per-level probes routed through the interval kernel (when gating
        admits a launch).  None for non-GLORAN strategies."""
        t = self.tree
        if t.strategy == "gloran" and t.gloran is not None:
            return partial(t.gloran.is_deleted_batch,
                           query_fn=self._query_drtree_level)
        return None

    def get_batch(self, keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Batched point lookups; (found, vals), order = request order.

        The fused cascade hook answers the whole filter stack in one
        launch when its gates admit the batch; the per-level bloom /
        interval hooks serve the same call when it declines."""
        self.cache.op_class = "get"
        return self.tree.get_batch(
            np.asarray(keys, dtype=np.uint64),
            cache=self.cache if self.cache.enabled else None,
            bloom_fn=self._bloom_maybe,
            validity_fn=self._validity_fn(),
            cascade_fn=self._cascade)

    def range_scan(self, lo: int, hi: int):
        """One range scan; (keys, vals) of the live entries in [lo, hi)."""
        return self.range_scan_batch([(lo, hi)])[0]

    def range_scan_batch(self, ranges) -> list:
        """Batched range scans through the tree's one-pass batch path,
        with GLORAN validity filtering on the interval kernel hook,
        merge-round positions on the merge-rank kernel hook, and slice
        charges absorbed by the shard's block cache; one (keys, vals)
        pair per requested [lo, hi), in request order."""
        self.cache.op_class = "range_scan"
        return self.tree.range_scan_batch(
            ranges, validity_fn=self._validity_fn(),
            cache=self.cache if self.cache.enabled else None,
            rank_fn=self._rank_fn())

    # --------------------------------------------------- cascade kernel
    def _cascade(self, keys: np.ndarray, resolved: np.ndarray,
                 seqs: np.ndarray) -> CascadeVerdict | None:
        """One fused launch for a lookup batch, or None to decline.

        Gates: the batch must be worth a launch (``kernel_min_batch``),
        the tree's packed view must exist (non-empty levels, u32-exact
        keys/seqs, within the pack budgets — see
        ``DeviceFilterRegistry``), and the query keys plus any
        memtable-resolved seqs must fit u32 working space.  A declined
        launch goes to the per-level route with identical results.
        """
        cfg = self.config
        if not cfg.use_cascade_kernel or len(keys) < cfg.kernel_min_batch:
            return None
        with span("shard.cascade", n=len(keys)):
            view = self.registry.view(self.tree)
            if view is None:
                return None
            if int(keys.max()) >= _U32_LIMIT:
                return None
            if resolved.any() and int(seqs[resolved].max()) >= _U32_LIMIT:
                return None
            with on_device(self.device):
                maybe, hit, gl_cov, pos = cascade_lookup(
                    keys.astype(np.uint32), fold64to32(keys),
                    seqs.astype(np.uint32), resolved, view.state)
        self.kernels.cascade_calls += 1
        self.kernels.cascade_queries += len(keys)
        return CascadeVerdict(slots=view.slots, maybe=maybe, hit=hit,
                              pos=pos,
                              gl_cov=gl_cov if view.has_gloran else None)

    # ----------------------------------------------------- merge kernel
    def _rank_fn(self):
        """The sorted-view merge hook of scans and compactions: two-way
        merge-round output positions through the merge-rank kernel when
        the round is big enough to pay for a launch and both runs fit
        u32 working space; declines (None -> host searchsorted)
        otherwise."""
        cfg = self.config
        if not cfg.use_merge_kernel:
            return None

        def rank(ka: np.ndarray, kb: np.ndarray):
            n = len(ka) + len(kb)
            if (n < cfg.kernel_min_merge or not len(ka) or not len(kb)
                    or int(ka[-1]) >= _U32_LIMIT
                    or int(kb[-1]) >= _U32_LIMIT):
                return None
            with on_device(self.device):
                pa, pb = merge_ranks(ka.astype(np.uint32),
                                     kb.astype(np.uint32), self.device)
            self.kernels.merge_calls += 1
            self.kernels.merge_keys += n
            return pa, pb

        return rank

    # --------------------------------------------------- filter kernels
    def _bloom_maybe(self, lvl, keys: np.ndarray) -> np.ndarray:
        """SSTable filter verdicts; kernel-launched when worth it.

        Filter words go to the kernel as the registry's device-resident
        copy (uploaded once per run uid), so the per-level route stops
        re-uploading the filter on every probe."""
        cfg = self.config
        bb = lvl.bloom
        if (cfg.use_bloom_kernel and len(keys) >= cfg.kernel_min_batch
                and len(lvl) >= cfg.kernel_min_filter):
            with on_device(self.device):
                out = bloom_probe(to_device(fold64to32(keys), self.device),
                                  self.registry.bloom_words(lvl),
                                  m_bits=bb.m_bits, seeds=bb.seeds)
            self.kernels.bloom_calls += 1
            self.kernels.bloom_queries += len(keys)
            return to_numpy(out, np.int32).astype(bool)
        return bb.might_contain(keys)

    def _query_drtree_level(self, lvl, keys: np.ndarray, seqs: np.ndarray,
                            io) -> np.ndarray:
        """Point-stab one DR-tree level; kernel-launched when worth it."""
        cfg = self.config
        if (cfg.use_interval_kernel
                and len(lvl) >= cfg.kernel_min_areas
                and len(keys) >= cfg.kernel_min_batch
                and int(keys.max()) < _U32_LIMIT
                and int(seqs.max()) < _U32_LIMIT):
            return self._interval_kernel_query(lvl, keys, seqs, io)
        return lvl.query_batch(keys, seqs, io=io)

    def _interval_kernel_query(self, lvl, keys: np.ndarray,
                               seqs: np.ndarray, io) -> np.ndarray:
        """One launch over a disjoint level; same I/O as a probe."""
        lo32, hi32, smin32, smax32 = self._level_u32(lvl)
        io.read_blocks(lvl.probe_cost() * len(keys), tag="drtree_probe")
        with on_device(self.device):
            out = interval_query(to_device(keys, self.device),
                                 to_device(seqs, self.device),
                                 lo32, hi32, smin32, smax32)
        self.kernels.interval_calls += 1
        self.kernels.interval_queries += len(keys)
        return to_numpy(out, np.int32).astype(bool)

    def _level_u32(self, lvl):
        """Clamped, padded u32 view of an immutable DR-tree level —
        the registry's device-resident piece (``clamp_level_u32``, the
        single source of the u32 transform), shared with the cascade's
        packed GLORAN view: one upload and one device copy serve both
        kernel paths."""
        live = [l for l in getattr(self.tree.gloran.index, "levels", [])
                if l is not None]
        return self.registry.gl_columns(lvl, live)
