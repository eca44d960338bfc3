"""Workload generation and execution for the paper's benchmarks.

Workloads are mixes of updates, point lookups, range lookups, and range
deletes over a uniform or Zipfian key distribution, executed in vectorized
batches (statistically equivalent to per-op interleaving; identical across
strategies so comparisons are fair).  Results carry wall-clock throughput,
per-op-type latency, and the simulated I/O ledger — the paper's own metric.

A copy of ``repro.baselines.workload`` over the port's ``core`` and
``lsm``: host numpy on a bare ``LSMTree``, with no kernel hook, so the
same seed gives the same op stream, I/O ledger and lookup results.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from ..core.gloran import GloranConfig
from ..core.lsm_drtree import LSMDRTreeConfig
from ..core.eve import RAEConfig
from ..lsm import LSMConfig, LSMTree


@dataclass
class WorkloadMix:
    lookup: float = 0.5
    update: float = 0.45
    range_delete: float = 0.05
    range_lookup: float = 0.0
    range_delete_len: int = 128
    range_lookup_len: int = 100
    universe: int = 1 << 24
    distribution: str = "uniform"  # or "zipfian"
    zipf_s: float = 0.99

    def normalized(self) -> "WorkloadMix":
        tot = self.lookup + self.update + self.range_delete + \
            self.range_lookup
        assert tot > 0
        return self


@dataclass
class WorkloadResult:
    n_ops: int
    wall_seconds: float
    ops_per_sec: float
    io_reads: int
    io_writes: int
    time_by_type: dict = field(default_factory=dict)
    io_by_type: dict = field(default_factory=dict)
    counts_by_type: dict = field(default_factory=dict)
    disk_bytes: int = 0
    memory_bytes: int = 0

    def io_per_op(self, op: str) -> float:
        c = self.counts_by_type.get(op, 0)
        return self.io_by_type.get(op, 0) / c if c else 0.0

    def modeled_ops_per_sec(self, t_io: float = 20e-6) -> float:
        """Device-grounded throughput: wall time + counted I/Os x t_io
        (default 20us ~ a 4 KB NVMe random read, the paper's hardware).
        The simulator counts I/Os instead of sleeping on them, so raw
        wall-clock alone under-charges I/O-heavy strategies."""
        total_io = self.io_reads + self.io_writes
        return self.n_ops / max(self.wall_seconds + total_io * t_io, 1e-9)

    def us_per_op(self, op: str) -> float:
        c = self.counts_by_type.get(op, 0)
        return 1e6 * self.time_by_type.get(op, 0.0) / c if c else 0.0


def zipf_keys(rng: np.random.Generator, n: int, universe: int,
              s: float = 0.99, n_distinct: int = 1 << 16) -> np.ndarray:
    """Zipfian keys over a bounded universe via inverse-CDF sampling."""
    ranks = np.arange(1, n_distinct + 1, dtype=np.float64)
    w = ranks ** (-s)
    cdf = np.cumsum(w)
    cdf /= cdf[-1]
    u = rng.random(n)
    idx = np.searchsorted(cdf, u)
    # Spread the hot ranks over the key universe deterministically.
    spread = (np.uint64(0x9E3779B97F4A7C15) *
              (idx.astype(np.uint64) + np.uint64(1)))
    return spread % np.uint64(universe)


def _draw_keys(rng, n, mix: WorkloadMix) -> np.ndarray:
    if mix.distribution == "zipfian":
        return zipf_keys(rng, n, mix.universe, mix.zipf_s)
    return rng.integers(0, mix.universe, size=n).astype(np.uint64)


def make_tree(strategy: str, *, buffer_capacity: int = 4096,
              size_ratio: int = 10, key_size: int = 256,
              value_size: int = 768, block_size: int = 4096,
              index_buffer: int = 8192, index_ratio: int = 10,
              eve_capacity: int = 100_000, eve_bits: int = 10,
              use_eve: bool = True, use_drtree: bool = True,
              universe: int = 1 << 24) -> LSMTree:
    cfg = LSMConfig(buffer_capacity=buffer_capacity, size_ratio=size_ratio,
                    key_size=key_size, value_size=value_size,
                    block_size=block_size, key_universe=universe)
    g = None
    if strategy == "gloran":
        g = GloranConfig(
            index=LSMDRTreeConfig(buffer_capacity=index_buffer,
                                  size_ratio=index_ratio, key_size=key_size,
                                  block_size=block_size),
            eve=RAEConfig(capacity=eve_capacity, bits_per_record=eve_bits,
                          key_universe=universe),
            use_eve=use_eve, use_drtree=use_drtree)
    return LSMTree(cfg, strategy=strategy, gloran_config=g)


def run_workload(tree: LSMTree, n_ops: int, mix: WorkloadMix,
                 seed: int = 0, batch: int = 512) -> WorkloadResult:
    mix = mix.normalized()
    rng = np.random.default_rng(seed)
    names = ["update", "lookup", "range_delete", "range_lookup"]
    ratios = np.array([mix.update, mix.lookup, mix.range_delete,
                       mix.range_lookup], dtype=np.float64)
    # Range ops execute batch//8 ops per drawn batch (they are per-op
    # calls); weight the batch-type draw by ratio / ops-per-batch so the
    # EFFECTIVE op mix matches the requested ratios.
    ops_per_batch = np.array([batch, batch, max(1, batch // 8),
                              max(1, batch // 8)], dtype=np.float64)
    probs = ratios / ops_per_batch
    probs /= probs.sum()
    time_by = {k: 0.0 for k in names}
    io_by = {k: 0 for k in names}
    cnt_by = {k: 0 for k in names}
    done = 0
    t_start = time.perf_counter()
    while done < n_ops:
        b = min(batch, n_ops - done)
        op = names[int(rng.choice(4, p=probs))]
        io0 = tree.io.total
        t0 = time.perf_counter()
        if op == "update":
            keys = _draw_keys(rng, b, mix)
            tree.put_batch(keys, keys * np.uint64(31) + np.uint64(7))
            n = b
        elif op == "lookup":
            keys = _draw_keys(rng, b, mix)
            tree.get_batch(keys)
            n = b
        elif op == "range_delete":
            # One range delete per "op"; a batch of b ops = b deletes.
            n = max(1, b // 8)  # cap per-batch count to keep interleaving
            los = _draw_keys(rng, n, mix)
            for lo in los.tolist():
                lo = min(lo, mix.universe - mix.range_delete_len - 1)
                tree.range_delete(lo, lo + mix.range_delete_len)
        else:  # range_lookup
            n = max(1, b // 8)
            los = _draw_keys(rng, n, mix)
            for lo in los.tolist():
                lo = min(lo, mix.universe - mix.range_lookup_len - 1)
                tree.range_scan(lo, lo + mix.range_lookup_len)
        dt = time.perf_counter() - t0
        time_by[op] += dt
        io_by[op] += tree.io.total - io0
        cnt_by[op] += n
        done += n
    wall = time.perf_counter() - t_start
    return WorkloadResult(
        n_ops=done, wall_seconds=wall, ops_per_sec=done / max(wall, 1e-9),
        io_reads=tree.io.reads, io_writes=tree.io.writes,
        time_by_type=time_by, io_by_type=io_by, counts_by_type=cnt_by,
        disk_bytes=tree.disk_bytes, memory_bytes=tree.memory_bytes)
