"""Engine-level rollups: throughput, latency, I/O, cache, kernel usage.

Each shard executor owns an ``IOStats`` ledger and kernel counters; the
engine aggregates them here, together with per-op-type wall time, so one
``engine.stats()`` call answers "what did the fleet do and what did it
cost" — the serving-tier analogue of ``LSMTree.stats``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..obs import LatencyHistogram


@dataclass
class KernelCounters:
    """How often the fused CUDA filter/merge stages actually ran."""

    interval_calls: int = 0     # interval_query launches (DR-tree levels)
    interval_queries: int = 0   # point-stab verdicts produced by them
    bloom_calls: int = 0        # bloom_probe launches (SSTable filters)
    bloom_queries: int = 0      # filter verdicts produced by them
    merge_calls: int = 0        # merge_ranks launches (scan merge rounds)
    merge_keys: int = 0         # keys positioned by them
    cascade_calls: int = 0      # fused lookup-cascade launches
    cascade_queries: int = 0    # lookups answered by the cascade
    cascade_packs: int = 0      # registry device-state (re)packs
    upload_bytes: int = 0       # host->device bytes moved by the packs
    # upload_bytes split by destination torch device ("cuda:0", "cpu"):
    # the per-device ledger the registry charges, so steady-state
    # "uploaded once per device, not once per batch" is assertable per
    # device.
    upload_bytes_by_device: dict = field(default_factory=dict)

    def merge(self, other: "KernelCounters") -> None:
        """Accumulate another ledger into this one (fleet rollups)."""
        self.interval_calls += other.interval_calls
        self.interval_queries += other.interval_queries
        self.bloom_calls += other.bloom_calls
        self.bloom_queries += other.bloom_queries
        self.merge_calls += other.merge_calls
        self.merge_keys += other.merge_keys
        self.cascade_calls += other.cascade_calls
        self.cascade_queries += other.cascade_queries
        self.cascade_packs += other.cascade_packs
        self.upload_bytes += other.upload_bytes
        for dev, nbytes in other.upload_bytes_by_device.items():
            self.upload_bytes_by_device[dev] = \
                self.upload_bytes_by_device.get(dev, 0) + nbytes

    def snapshot(self) -> dict:
        return {
            "interval_calls": self.interval_calls,
            "interval_queries": self.interval_queries,
            "bloom_calls": self.bloom_calls,
            "bloom_queries": self.bloom_queries,
            "merge_calls": self.merge_calls,
            "merge_keys": self.merge_keys,
            "cascade_calls": self.cascade_calls,
            "cascade_queries": self.cascade_queries,
            "cascade_packs": self.cascade_packs,
            "upload_bytes": self.upload_bytes,
            "upload_bytes_by_device": dict(sorted(
                self.upload_bytes_by_device.items())),
        }


@dataclass
class EngineStats:
    """Per-op-class rollups of everything the engine executed.

    ``record`` is called once per engine-level batch with the op class
    (``get``, ``put``, ``delete``, ``range_scan``, ``range_delete``,
    ``mixed``), the number of logical ops in the batch, its wall time,
    and the simulated block I/O it charged — so latency AND I/O are
    attributable per op class, not just in aggregate.
    """

    ops: dict = field(default_factory=dict)        # op -> count
    wall: dict = field(default_factory=dict)       # op -> seconds
    batches: dict = field(default_factory=dict)    # op -> batch count
    io_reads: dict = field(default_factory=dict)   # op -> blocks read
    io_writes: dict = field(default_factory=dict)  # op -> blocks written
    shard_wall: dict = field(default_factory=dict)   # shard -> busy s
    shard_stall: dict = field(default_factory=dict)  # shard -> idle s
    pipelined_batches: int = 0
    serial_batches: int = 0
    staging: dict = field(default_factory=dict)      # buffer occupancy
    latency: dict = field(default_factory=dict)      # op -> histogram
    shard_latency: dict = field(default_factory=dict)  # shard -> histogram

    def record(self, op: str, n: int, seconds: float,
               io_reads: int = 0, io_writes: int = 0) -> None:
        self.ops[op] = self.ops.get(op, 0) + int(n)
        self.wall[op] = self.wall.get(op, 0.0) + float(seconds)
        self.batches[op] = self.batches.get(op, 0) + 1
        self.io_reads[op] = self.io_reads.get(op, 0) + int(io_reads)
        self.io_writes[op] = self.io_writes.get(op, 0) + int(io_writes)
        hist = self.latency.get(op)
        if hist is None:
            hist = self.latency[op] = LatencyHistogram()
        hist.record(seconds)

    def record_shards(self, walls: dict, pipelined: bool) -> None:
        """Per-shard busy/stall seconds for one submitted batch.

        ``walls`` maps shard id -> that shard's plan execution time.  A
        batch's critical path is its slowest shard; every other shard
        *stalls* for the difference (idle while the merge-back waits).
        Observable pipeline health: a balanced fleet has stall ~ 0, a
        skewed one shows where the wall time actually went.
        """
        if pipelined:
            self.pipelined_batches += 1
        else:
            self.serial_batches += 1
        if not walls:
            return
        crit = max(walls.values())
        for s, w in walls.items():
            self.shard_wall[s] = self.shard_wall.get(s, 0.0) + float(w)
            self.shard_stall[s] = self.shard_stall.get(s, 0.0) + \
                float(crit - w)
            hist = self.shard_latency.get(s)
            if hist is None:
                hist = self.shard_latency[s] = LatencyHistogram()
            hist.record(w)

    def record_staging(self, per_shard: list[dict]) -> None:
        """Current staging-buffer occupancy across the GLORAN shards.

        ``per_shard`` entries come from ``GloranIndex.buffer_snapshot``;
        the rollup keeps the fleet totals and the fill fraction so
        "how close is the next index flush" is answerable from stats.
        """
        recs = sum(d["records"] for d in per_shard)
        cap = sum(d["capacity"] for d in per_shard)
        self.staging = {
            "records": recs,
            "capacity": cap,
            "occupancy": round(recs / cap, 4) if cap else 0.0,
            "per_shard": per_shard,
        }

    def reset(self) -> None:
        """Zero every rollup (counts, walls, I/O, histograms).

        Long-lived serving sessions call this at window boundaries so
        ``snapshot()`` reports per-window latency/throughput instead of
        since-boot cumulative only (see ``Engine.reset_stats``).
        """
        for d in (self.ops, self.wall, self.batches, self.io_reads,
                  self.io_writes, self.shard_wall, self.shard_stall,
                  self.staging, self.latency, self.shard_latency):
            d.clear()
        self.pipelined_batches = 0
        self.serial_batches = 0

    def ops_per_sec(self, op: str) -> float:
        return self.ops.get(op, 0) / max(self.wall.get(op, 0.0), 1e-12)

    def us_per_op(self, op: str) -> float:
        n = self.ops.get(op, 0)
        return 1e6 * self.wall.get(op, 0.0) / n if n else 0.0

    def io_per_op(self, op: str) -> float:
        """Blocks (read + written) charged per logical op of this class."""
        n = self.ops.get(op, 0)
        io = self.io_reads.get(op, 0) + self.io_writes.get(op, 0)
        return io / n if n else 0.0

    def snapshot(self) -> dict:
        """Schema: each entry maps op class -> value.

        ``ops`` logical ops executed; ``batches`` engine-level calls;
        ``wall_seconds`` total wall time; ``ops_per_sec`` / ``us_per_op``
        derived throughput/latency; ``io_reads`` / ``io_writes`` blocks
        charged while serving that class; ``io_per_op`` blocks per op;
        ``shard_wall_seconds`` / ``shard_stall_seconds`` per-shard
        busy/idle time across submitted batches; ``pipelined_batches`` /
        ``serial_batches`` how each batch executed; ``staging_buffer``
        the current range-delete staging-buffer occupancy; ``latency``
        per-op-class batch-latency histograms (count/mean/p50/p95/p99,
        microseconds) and ``shard_latency`` the same per shard over its
        plan execution walls — the tail-latency view the scalar
        ``us_per_op`` mean cannot give.
        """
        return {
            "latency": {k: h.snapshot()
                        for k, h in sorted(self.latency.items())},
            "shard_latency": {s: h.snapshot()
                              for s, h in sorted(self.shard_latency
                                                 .items())},
            "pipelined_batches": self.pipelined_batches,
            "serial_batches": self.serial_batches,
            "staging_buffer": dict(self.staging),
            "shard_wall_seconds": {s: round(v, 6)
                                   for s, v in self.shard_wall.items()},
            "shard_stall_seconds": {s: round(v, 6)
                                    for s, v in self.shard_stall.items()},
            "ops": dict(self.ops),
            "wall_seconds": {k: round(v, 6) for k, v in self.wall.items()},
            "batches": dict(self.batches),
            "ops_per_sec": {k: round(self.ops_per_sec(k), 1)
                            for k in self.ops},
            "us_per_op": {k: round(self.us_per_op(k), 3) for k in self.ops},
            "io_reads": dict(self.io_reads),
            "io_writes": dict(self.io_writes),
            "io_per_op": {k: round(self.io_per_op(k), 4) for k in self.ops},
        }


def merge_io_snapshots(snaps: list[dict]) -> dict:
    """Sum per-shard IOStats snapshots into one fleet ledger."""
    out = {"reads": 0, "writes": 0, "total": 0, "by_tag": {}}
    for s in snaps:
        out["reads"] += s["reads"]
        out["writes"] += s["writes"]
        out["total"] += s["total"]
        for tag, n in s["by_tag"].items():
            out["by_tag"][tag] = out["by_tag"].get(tag, 0) + n
    return out
