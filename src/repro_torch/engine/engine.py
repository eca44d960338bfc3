"""Sharded batched query engine fronting N LSM-tree shards.

Organized as **plan -> submit -> collect**: a ``Planner`` compiles a
typed ``OpBatch`` into per-shard ``ShardPlan``s (vectorized routing,
range clipping, same-kind run grouping), ``Engine.submit`` launches
those plans — concurrently across shards when pipelining is on, serially
in shard order when off — and the returned ``PendingBatch`` merges
results back in request order.  ``get_batch``, ``put_batch`` and the
other conveniences are thin wrappers that build an ``OpBatch`` and block
on ``submit``.

Every shard keeps its filter state on ``EngineConfig.device`` and runs
its kernels there.  This package serves writes and point lookups; range
scans, durability, worker processes and background compaction raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..core.gloran import GloranConfig
from ..device import resolve_device
from ..lsm import LSMConfig, LSMTree
from ..obs import MetricsRegistry, span
from .executor import EngineConfig, ShardExecutor
from .pending import PendingBatch
from .plan import OP_RANGE_SCAN, OpBatch, Planner
from .router import ShardRouter
from .stats import EngineStats, KernelCounters, merge_io_snapshots

_SCANS = "Queue A item 6 (range scans through the engine)"


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
    """Sharded, batched execution of writes and point lookups.

    Public surface (all batch results come back in request order):

      submit(OpBatch) -> PendingBatch          plan + launch, collect later
      put_batch / delete_batch / get_batch     vectorized point ops
      put / delete / get                       scalar conveniences
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
    """

    def __init__(self, num_shards: int = 1, strategy: str = "gloran",
                 lsm_config: LSMConfig | None = None,
                 gloran_config: GloranConfig | None = None,
                 config: EngineConfig | None = None):
        self.config = config or EngineConfig()
        self.device = resolve_device(self.config.device)
        self.num_shards = int(num_shards)
        self.strategy = strategy
        base = lsm_config or LSMConfig()
        self.lsm_config = base
        self.gloran_config = gloran_config
        self.router = ShardRouter(self.num_shards,
                                  partition=self.config.partition,
                                  universe=base.key_universe)
        self.planner = Planner(self.router)
        self.shards = [
            ShardExecutor(LSMTree(base, strategy=strategy,
                                  gloran_config=gloran_config),
                          self.config, self.device)
            for _ in range(self.num_shards)]
        self.stats_ = EngineStats()
        self.metrics = MetricsRegistry()
        self.pipeline_default = bool(self.config.pipeline)
        self._pools: list[ThreadPoolExecutor] | None = None
        self._inflight: list[PendingBatch] = []
        self._inflight_lock = threading.Lock()

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
        if (batch.kinds == OP_RANGE_SCAN).any():
            raise NotImplementedError(
                f"range scans are not ported to repro_torch yet: "
                f"ROADMAP {_SCANS}")
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
        """Block until every in-flight submitted batch has collected."""
        while True:
            with self._inflight_lock:
                if not self._inflight:
                    break
                pending = self._inflight[0]
            pending.wait()

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
        """Flush every shard's memtable to its level 0 (drains first)."""
        self.drain()
        for sh in self.shards:
            sh.flush()

    def close(self) -> None:
        """Deterministic shutdown (idempotent): drain in-flight batches
        and join the per-shard worker pools."""
        self.drain()
        if self._pools is not None:
            for p in self._pools:
                p.shutdown(wait=True)
            self._pools = None

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
        raise NotImplementedError(
            f"range scans are not ported to repro_torch yet: "
            f"ROADMAP {_SCANS}")

    def range_scan_batch(self, ranges) -> list:
        raise NotImplementedError(
            f"range scans are not ported to repro_torch yet: "
            f"ROADMAP {_SCANS}")

    # --------------------------------------------------------- mixed ops
    def execute(self, ops: list[tuple]) -> list:
        """Execute a mixed tuple op stream; results align with request
        order: gets yield value-or-None, writes yield None.

        ``ops`` entries: ``("put", key, val)``, ``("delete", key)``,
        ``("get", key)``, ``("range_delete", lo, hi)``.  Consecutive
        same-kind ops destined for the same shard execute as one
        vectorized sub-batch; per-shard arrival order is preserved.
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
        fulls = [sh.stats_full() for sh in self.shards]
        staging = [{"shard": s, **f["staging"]}
                   for s, f in enumerate(fulls)
                   if f["staging"] is not None]
        if staging:
            self.stats_.record_staging(staging)
        out = {
            "num_shards": self.num_shards,
            "partition": self.router.partition,
            "pipeline": self.pipeline_default,
            "device": str(self.device),
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
            "num_shards": self.num_shards})
        if self.stats_.staging:
            m.absorb("staging", {k: v for k, v in
                                 self.stats_.staging.items()
                                 if k != "per_shard"})
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
        out["metrics"] = m.snapshot()
        return out
