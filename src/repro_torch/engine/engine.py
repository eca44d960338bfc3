"""Sharded batched query engine fronting N LSM-tree shards.

Organized as **plan -> submit -> collect**: a ``Planner`` compiles a
typed ``OpBatch`` into per-shard ``ShardPlan``s (vectorized routing,
range clipping, same-kind run grouping), ``Engine.submit`` launches
those plans — concurrently across shards when pipelining is on, serially
in shard order when off — and the returned ``PendingBatch`` merges
results back in request order.  ``get_batch``, ``range_scan_batch``,
``execute`` and the other conveniences are thin wrappers that build an
``OpBatch`` and block on ``submit``.

Every shard keeps its filter state on its home device (by default
``EngineConfig.device``; ``EngineConfig.devices`` spreads the shards over
the cards) and runs its kernels there.  This package serves writes,
point lookups and range scans, with background compaction on or off,
with a write-ahead log and level manifest when ``EngineConfig.wal_dir``
is set (reopened after a crash by ``repro_torch.durable.recover``), and
with the shards in worker processes when ``EngineConfig.procs`` is set
(``engine/procpool.py``), each worker holding a CUDA context of its own.
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..core.gloran import GloranConfig
from ..device import resolve_device, shard_devices
from ..durable.manifest import LevelManifest, engine_config_doc
from ..durable.wal import WalWriter, wal_has_frames
from ..lsm import LSMConfig, LSMTree
from ..lsm.merge import merge_runs
from ..lsm.scheduler import CompactionScheduler
from ..obs import MetricsRegistry, span
from .executor import EngineConfig, ShardExecutor
from .pending import PendingBatch
from .plan import OpBatch, Planner
from .router import ShardRouter
from .stats import EngineStats, KernelCounters, merge_io_snapshots

_EMPTY_KV = (np.zeros(0, np.uint64), np.zeros(0, np.uint64))


def _resolve_procs(config: EngineConfig, num_shards: int) -> int:
    """Worker-process count, or 0 for the in-process path: None/0 =
    off (byte-identical in-process execution); N spawns min(N,
    num_shards) workers, shards assigned round-robin."""
    want = int(config.procs or 0)
    return min(want, num_shards) if want > 0 else 0


def _sum_counters(docs: list) -> dict:
    """Per-shard counter dicts -> their sums, key by key."""
    agg: dict = {}
    for c in docs:
        for k, v in c.items():
            agg[k] = agg.get(k, 0) + v
    return agg


def _merge_cache_snaps(snaps: list) -> dict:
    """Per-shard BlockCache snapshots -> one fleet rollup."""
    hits = sum(s["hits"] for s in snaps)
    misses = sum(s["misses"] for s in snaps)
    by_class: dict = {}
    for s in snaps:
        for cls, d in s["by_class"].items():
            agg = by_class.setdefault(cls, {"hits": 0, "misses": 0})
            agg["hits"] += d["hits"]
            agg["misses"] += d["misses"]
    for d in by_class.values():
        tot = d["hits"] + d["misses"]
        d["hit_rate"] = d["hits"] / tot if tot else 0.0
    return {"hits": hits, "misses": misses,
            "hit_rate": hits / (hits + misses) if hits + misses else 0.0,
            "by_class": by_class,
            "per_shard": snaps}


class Engine:
    """Sharded, batched execution of point AND range ops.

    Public surface (all batch results come back in request order):

      submit(OpBatch) -> PendingBatch          plan + launch, collect later
      put_batch / delete_batch / get_batch     vectorized point ops
      put / delete / get                       scalar conveniences
      range_scan_batch / range_scan            sorted live entries per range
      range_delete_batch / range_delete        strategy-dispatched deletes
      execute(ops)                             one mixed tuple op stream
      drain()                                  join all in-flight batches
      stats() / cache_snapshot()               per-op-class rollups

    Pipelining: with ``EngineConfig.pipeline`` on (the default) and more
    than one shard, each shard executes its plan on a dedicated
    single-worker pool — shards run concurrently, every shard sees its
    batches in submit order, and ``submit`` returns before execution
    finishes.  ``pipeline=False`` runs the identical plans inline in
    shard order; results are byte-identical either way.

    Range ops route like point ops: range-partitioned shards serve only
    the overlapping slabs (clipped), hash-partitioned shards fan out and
    the per-shard results — disjoint because every key owns exactly one
    shard — are merged back into one sorted view per request.

    Background compaction (``EngineConfig.scheduler``): every shard gets
    a ``CompactionScheduler``; full memtables seal and their flushes and
    cascades run at each plan's start, at ``drain`` / ``flush`` /
    ``stats`` / ``close``, or under backpressure, byte-identical to the
    inline engine.

    Durability (``EngineConfig.wal_dir``): every shard appends one WAL
    frame per plan before its steps run, and a batch is acknowledged
    only after that append (fsynced under ``fsync="batch"``); the level
    manifest records the config and each structural edit.
    """

    def __init__(self, num_shards: int = 1, strategy: str = "gloran",
                 lsm_config: LSMConfig | None = None,
                 gloran_config: GloranConfig | None = None,
                 config: EngineConfig | None = None,
                 _recover_from: str | None = None):
        self.config = config or EngineConfig()
        self.device = resolve_device(self.config.device)
        self.num_shards = int(num_shards)
        self.strategy = strategy
        base = lsm_config or LSMConfig()
        self.lsm_config = base
        self.gloran_config = gloran_config
        # The gloran config the shards actually run (GloranIndex
        # defaults None to GloranConfig()); the manifest's config doc
        # serializes THIS so recovery rebuilds identically.
        self._gloran_eff = ((gloran_config or GloranConfig())
                            if strategy == "gloran" else None)
        self.router = ShardRouter(self.num_shards,
                                  partition=self.config.partition,
                                  universe=base.key_universe)
        self.planner = Planner(self.router)
        # Per-shard home devices (None = every shard on ``self.device``):
        # each shard's registry packs and kernel launches live on its
        # device.
        self.devices = shard_devices(self.num_shards, self.config.device,
                                     self.config.devices)
        self.background = bool(self.config.scheduler)
        # A directory that already holds acknowledged frames is refused
        # — recovery must fold them in first, or acked writes would be
        # silently orphaned.  (``_recover_from`` is that fold-in:
        # ``repro_torch.durable.recover`` passes it in procs mode so each
        # worker replays its own stream before serving.)
        if self.config.wal_dir and not _recover_from:
            if wal_has_frames(self.config.wal_dir):
                raise RuntimeError(
                    f"WAL at {self.config.wal_dir} holds acknowledged "
                    "frames; open it with repro_torch.durable.recover() "
                    "instead of a fresh Engine")
        # Process-parallel shard execution (engine/procpool.py).
        self.procs = _resolve_procs(self.config, self.num_shards)
        self._proc_pool = None
        if _recover_from and not self.procs:
            raise RuntimeError("_recover_from is the procs-mode "
                               "recovery path; use durable.recover()")
        homes = self.devices or [self.device] * self.num_shards
        if self.procs:
            from .procpool import ProcPool
            self._proc_pool = ProcPool(
                num_shards=self.num_shards, procs=self.procs,
                strategy=strategy, lsm_config=base,
                gloran_config=gloran_config, config=self.config,
                background=self.background,
                device_ids=[str(d) for d in homes],
                wal_dir=self.config.wal_dir or _recover_from,
                replay=bool(_recover_from))
            self.shards = self._proc_pool.shards
        else:
            self.shards = [
                ShardExecutor(LSMTree(base, strategy=strategy,
                                      gloran_config=gloran_config),
                              self.config, home)
                for home in homes]
            if self.background:
                for sh in self.shards:
                    sh.attach_scheduler(CompactionScheduler(
                        sh.tree, max_frozen=self.config.max_frozen,
                        tombstone_trigger=self.config.tombstone_trigger))
        self.stats_ = EngineStats()
        self.metrics = MetricsRegistry()
        self.pipeline_default = bool(self.config.pipeline)
        self._pools: list[ThreadPoolExecutor] | None = None
        self._inflight: list[PendingBatch] = []
        self._inflight_lock = threading.Lock()
        # Durability (repro_torch.durable): a configured wal_dir attaches
        # a per-shard WAL stream + the level manifest.  In procs mode the
        # WAL writers live INSIDE the workers (append-before-ack holds
        # within each worker's run_plan); the parent owns the manifest,
        # applying structure edits shipped back with each reply.
        self.wal_dir: str | None = None
        self.manifest = None
        self.recovery = {"wall_s": 0.0, "frames_replayed": 0,
                         "snapshot_loaded": 0}
        if self.procs:
            d = self.config.wal_dir or _recover_from
            if d:
                self._attach_proc_durability(
                    d, recovered=bool(_recover_from))
        elif self.config.wal_dir:
            self._attach_durability(self.config.wal_dir)

    def _attach_proc_durability(self, wal_dir: str, *,
                                recovered: bool) -> None:
        """Procs-mode durability wiring: manifest in the parent, WAL
        writers in the workers (already attached by ProcPool)."""
        self.wal_dir = wal_dir
        if recovered:
            manifest = LevelManifest.load(os.path.join(wal_dir,
                                                       "manifest"))
        else:
            manifest = LevelManifest(
                os.path.join(wal_dir, "manifest"),
                config=engine_config_doc(self), fsync=False)
            manifest.commit(fsync=self.config.fsync != "never")
        self.manifest = manifest
        for sh in self.shards:
            sh.manifest = manifest
        if recovered:
            for s, desc in sorted(
                    self._proc_pool.recovered_descs.items()):
                manifest.record_structure_desc(s, desc, reason="recover")
            self.recovery["frames_replayed"] = \
                self._proc_pool.frames_replayed

    def _attach_durability(self, wal_dir: str, *, manifest=None,
                           writers: list | None = None) -> None:
        """Wire WAL writers + manifest into every shard.  Called from
        ``__init__`` for a fresh store and from
        ``repro_torch.durable.recover`` after replay (which passes the
        loaded manifest and writers positioned at the durable tail)."""
        self.wal_dir = wal_dir
        if manifest is None:
            # Routine structure commits skip fsync (not load-bearing —
            # recovery replays the WAL); the initial commit carries the
            # config doc recovery rebuilds the engine from, so THAT one
            # is made durable explicitly.
            manifest = LevelManifest(
                os.path.join(wal_dir, "manifest"),
                config=engine_config_doc(self), fsync=False)
            manifest.commit(fsync=self.config.fsync != "never")
        self.manifest = manifest
        for s, sh in enumerate(self.shards):
            w = (writers[s] if writers is not None else
                 WalWriter(wal_dir, s,
                           segment_bytes=self.config.wal_segment_bytes,
                           fsync=self.config.fsync))
            sh.attach_durability(w, manifest, s)

    # -------------------------------------------------- submit / collect
    def submit(self, batch: OpBatch, *,
               pipeline: bool | None = None) -> PendingBatch:
        """Plan and launch a typed op batch; collect via the handle.

        ``pipeline=None`` uses the engine default.  Pipelined submits
        return immediately (execution proceeds on the shard pools);
        serial submits execute inline before returning, after draining
        any in-flight pipelined work so the per-shard op order stays the
        submit order.
        """
        if pipeline is None:
            pipeline = self.pipeline_default
        pipeline = bool(pipeline) and self.num_shards > 1
        with span("engine.submit", kind=batch.kind_name, n_ops=len(batch),
                  pipelined=pipeline):
            plan = self.planner.plan(batch)
            if not pipeline:
                self.drain()
                pending = PendingBatch(self, plan, pipeline=False)
                pending._start()
                return pending.wait()
            pending = PendingBatch(self, plan, pipeline=True)
            # Launch before publishing: a concurrent drain()/stats()
            # must never collect a handle whose shard plans haven't
            # started.
            pending._start()
            with self._inflight_lock:
                self._inflight.append(pending)
            return pending

    def drain(self) -> None:
        """Block until every in-flight submitted batch has collected,
        then run any due background scheduler jobs — a drained engine
        is fully caught up (flushes published, cascades applied),
        exactly the state the inline path would be in."""
        while True:
            with self._inflight_lock:
                if not self._inflight:
                    break
                pending = self._inflight[0]
            pending.wait()
        if self.background:
            for sh in self.shards:
                sh.run_scheduler("drain")

    def _shard_pools(self) -> list[ThreadPoolExecutor]:
        """One single-worker pool per shard: cross-shard parallelism with
        per-shard FIFO (a later batch never overtakes an earlier one on
        the same shard — all ordering correctness needs)."""
        if self._pools is None:
            self._pools = [
                ThreadPoolExecutor(max_workers=1,
                                   thread_name_prefix=f"shard-{s}")
                for s in range(self.num_shards)]
        return self._pools

    def _finish_batch(self, pending: PendingBatch) -> None:
        """Merge-back bookkeeping: roll one collected batch into stats.

        With overlapping in-flight batches the engine-wide I/O delta is
        attributed to whichever batch collects it first — per-op-class
        I/O stays exact for the blocking wrappers and approximate under
        concurrent ``submit`` streams.
        """
        batch = pending.plan.batch
        reads, writes = self._io_marks()
        self.stats_.record(
            batch.kind_name, len(batch),
            time.perf_counter() - pending._t0,
            io_reads=reads - pending._io0[0],
            io_writes=writes - pending._io0[1])
        self.stats_.record_shards(pending._walls, pending.pipeline)
        with self._inflight_lock:
            if pending in self._inflight:
                self._inflight.remove(pending)

    def _io_marks(self) -> tuple[int, int]:
        return self.io_reads, self.io_writes

    # ------------------------------------------------------------ writes
    def put_batch(self, keys: np.ndarray, vals: np.ndarray) -> None:
        """Insert a batch of (key, val) pairs (split across shards)."""
        self.submit(OpBatch.puts(keys, vals)).wait()

    def put(self, key: int, val: int) -> None:
        """Scalar insert (a one-element ``put_batch``)."""
        self.put_batch(np.asarray([key], np.uint64),
                       np.asarray([val], np.uint64))

    def delete_batch(self, keys: np.ndarray) -> None:
        """Point-delete a batch of keys (split across shards)."""
        self.submit(OpBatch.deletes(keys)).wait()

    def delete(self, key: int) -> None:
        """Scalar point delete (a one-element ``delete_batch``)."""
        self.delete_batch(np.asarray([key], np.uint64))

    def range_delete(self, lo: int, hi: int) -> None:
        """Delete all keys in [lo, hi) on every owning shard."""
        self.range_delete_batch([(lo, hi)])

    def range_delete_batch(self, ranges) -> None:
        """Apply a batch of [lo, hi) range deletes.

        Each range is routed like any range op — clipped to overlapping
        slabs under range partitioning, broadcast under hash — and every
        shard applies its visits in request order, so a later op in the
        batch shadows an earlier one exactly as sequential calls would.
        """
        self.submit(OpBatch.range_deletes(ranges)).wait()

    def flush(self) -> None:
        """Flush every shard's memtable to its level 0 (drains first).
        Durable shards log a FLUSH marker + manifest edit each."""
        self.drain()
        for sh in self.shards:
            sh.flush()

    def close(self) -> None:
        """Deterministic shutdown (idempotent): drain in-flight batches
        and pending scheduler jobs, join the per-shard worker pools, and
        flush + fsync + close every WAL stream (in procs mode: close
        the worker processes, which close theirs) — tests and benches
        never leak worker threads, processes or half-written segments."""
        self.drain()
        if self._pools is not None:
            for p in self._pools:
                p.shutdown(wait=True)
            self._pools = None
        if self._proc_pool is not None:
            self._proc_pool.close()
        else:
            for sh in self.shards:
                sh.close()

    def __enter__(self) -> "Engine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------- reads
    def get_batch(self, keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Vectorized point lookups; (found mask, values) in request
        order, merged back from the per-shard batched read paths."""
        return self.submit(OpBatch.gets(keys)).get_results()

    def get(self, key: int):
        """Scalar point lookup; the value or None."""
        found, vals = self.get_batch(np.asarray([key], np.uint64))
        return int(vals[0]) if found[0] else None

    def range_scan(self, lo: int, hi: int):
        """All live entries in [lo, hi) across shards, sorted by key."""
        return self.range_scan_batch([(lo, hi)])[0]

    def range_scan_batch(self, ranges) -> list:
        """Execute a batch of range scans; one sorted (keys, vals) pair
        per requested [lo, hi), in request order.

        Each shard serves its clipped visits in ONE pass over its tree
        (``LSMTree.range_scan_batch``: shared memtable snapshot,
        vectorized slice bounds, sorted-view merges on the merge-rank
        kernel hook, batched validity filtering on the interval kernel
        hook).  Per-request results from range-partitioned shards
        concatenate in slab order (already globally sorted);
        hash-partitioned shards return disjoint sorted sets that are
        merged as sorted views.
        """
        return self.submit(OpBatch.range_scans(ranges)).scan_results()

    def _merge_scan_parts(self, parts: list) -> tuple[np.ndarray,
                                                      np.ndarray]:
        """One request's per-shard (keys, vals) parts -> one sorted pair.

        Shards are visited in ascending order, so under range
        partitioning the parts are consecutive key slabs and concatenate
        sorted; under hash partitioning each key lives on exactly one
        shard, so the parts are disjoint sorted sets and a host
        sorted-view merge (no re-sort, no kernel) is exact.
        """
        if not parts:
            return _EMPTY_KV
        if len(parts) == 1:
            return parts[0]
        if self.router.partition == "range":
            return (np.concatenate([p[0] for p in parts]),
                    np.concatenate([p[1] for p in parts]))
        return merge_runs(parts, empty=_EMPTY_KV)

    # --------------------------------------------------------- mixed ops
    def execute(self, ops: list[tuple]) -> list:
        """Execute a mixed tuple op stream; results align with request
        order: gets yield value-or-None, range scans yield a sorted
        (keys, vals) pair, writes yield None.

        ``ops`` entries: ``("put", key, val)``, ``("delete", key)``,
        ``("get", key)``, ``("range_delete", lo, hi)``,
        ``("range_scan", lo, hi)``.  Consecutive same-kind ops destined
        for the same shard execute as one vectorized sub-batch;
        per-shard arrival order is preserved.  Range ops visit every
        owning shard; a scan's per-shard parts are merged back into one
        sorted view.
        """
        return self.submit(OpBatch.from_ops(ops)).results()

    # -------------------------------------------------------------- misc
    @property
    def io_reads(self) -> int:
        return sum(sh.io_reads for sh in self.shards)

    @property
    def io_writes(self) -> int:
        return sum(sh.io_writes for sh in self.shards)

    @property
    def num_entries(self) -> int:
        return sum(sh.num_entries for sh in self.shards)

    @property
    def kernel_counters(self) -> KernelCounters:
        out = KernelCounters()
        for sh in self.shards:
            out.merge(sh.kernels)
        return out

    def device_map(self) -> dict:
        """shard id -> home device string (``self.device``'s on the
        single-device path)."""
        homes = self.devices or [self.device] * self.num_shards
        return {s: str(d) for s, d in enumerate(homes)}

    def cache_snapshot(self) -> dict:
        return _merge_cache_snaps([sh.cache_snapshot()
                                   for sh in self.shards])

    def reset_stats(self) -> None:
        """Start a fresh stats window: drain in-flight work, then zero
        the engine rollups (op counts, walls, I/O attribution, latency
        histograms) and the unified metrics snapshot.  The shard-local
        cumulative ledgers (IOStats, kernel counters, cache hit totals)
        keep running."""
        self.drain()
        self.stats_.reset()
        self.metrics.reset()

    def stats(self) -> dict:
        self.drain()
        # ONE per-shard ledger document each — in-process executors
        # read their tree directly, proc shards round-trip a STATS
        # message to their worker.  Everything below aggregates these
        # documents only, so both modes share one code path, and the
        # values are cumulative snapshots: calling stats() twice
        # without intervening work returns identical numbers.
        fulls = [sh.stats_full() for sh in self.shards]
        staging = [{"shard": s, **f["staging"]}
                   for s, f in enumerate(fulls)
                   if f["staging"] is not None]
        if staging:
            self.stats_.record_staging(staging)
        device_map = self.device_map()
        out = {
            "num_shards": self.num_shards,
            "partition": self.router.partition,
            "pipeline": self.pipeline_default,
            "device": str(self.device),
            "procs": self.procs,
            "devices": {
                "enabled": self.devices is not None,
                "distinct": len(set(device_map.values())),
                "per_shard": device_map,
            },
            "entries": sum(f["entries"] for f in fulls),
            "engine": self.stats_.snapshot(),
            "io": merge_io_snapshots([f["io"] for f in fulls]),
            "cache": _merge_cache_snaps([f["cache"] for f in fulls]),
            "kernels": self.kernel_counters.snapshot(),
        }
        m = self.metrics
        m.absorb("kernels", out["kernels"])
        m.absorb("io", {k: v for k, v in out["io"].items()
                        if k != "by_tag"})
        m.absorb("io.by_tag", out["io"]["by_tag"])
        m.absorb("cache", {k: out["cache"][k]
                           for k in ("hits", "misses", "hit_rate")})
        m.absorb("cache.by_class", out["cache"]["by_class"])
        m.absorb("engine", {
            "pipelined_batches": self.stats_.pipelined_batches,
            "serial_batches": self.stats_.serial_batches,
            "entries": out["entries"],
            "num_shards": self.num_shards,
            "devices": out["devices"]["distinct"]})
        if self.stats_.staging:
            m.absorb("staging", {k: v for k, v in
                                 self.stats_.staging.items()
                                 if k != "per_shard"})
        # Background-scheduler health: job/stall counters + compaction
        # debt across the fleet (``sched.*`` metrics).
        scheds = [f["sched"] for f in fulls if f["sched"] is not None]
        if scheds:
            agg = _sum_counters(scheds)
            agg["stall_seconds"] = round(agg["stall_seconds"], 6)
            out["sched"] = agg
            m.absorb("sched", agg)
        lsm_m: dict = {}
        for f in fulls:
            for i, b in f["lsm"]["compaction_bytes"].items():
                k = f"compaction.bytes.L{i}"
                lsm_m[k] = lsm_m.get(k, 0) + b
            for i, b in f["lsm"]["rt_compaction_bytes"].items():
                k = f"rt_compaction.bytes.L{i}"
                lsm_m[k] = lsm_m.get(k, 0) + b
        for i in range(max((f["lsm"]["num_levels"] for f in fulls),
                           default=0)):
            dens = [f["lsm"]["rt_density"][i] for f in fulls
                    if i < f["lsm"]["num_levels"]]
            if dens:
                lsm_m[f"rt_density.L{i}"] = round(max(dens), 4)
        if lsm_m:
            out["lsm"] = lsm_m
            m.absorb("lsm", lsm_m)
        # WAL ledger (bytes, appends, fsyncs, frames, segments) across
        # the shards, and the last recovery's timings.
        wals = [f["wal"] for f in fulls if f["wal"] is not None]
        if wals:
            agg = _sum_counters(wals)
            out["wal"] = agg
            m.absorb("wal", agg)
        # GLORAN's point-lookup validity counters across the shards
        # (``gloran.*`` metrics: EVE's false positives read from them).
        glorans = [f["gloran"] for f in fulls if f["gloran"] is not None]
        if glorans:
            agg = _sum_counters(glorans)
            out["gloran"] = agg
            m.absorb("gloran", agg)
        # Shared-memory transport ledger (procs mode): bytes shipped
        # each way + the enqueue->dequeue latency histogram.
        if self._proc_pool is not None:
            t = self._proc_pool.transport_snapshot()
            out["proc"] = t
            m.absorb("proc", {k: v for k, v in t.items()
                              if k != "dequeue_latency_us"})
            m.absorb("proc.dequeue_latency_us",
                     t["dequeue_latency_us"])
        m.absorb("recovery", self.recovery)
        out["metrics"] = m.snapshot()
        return out
