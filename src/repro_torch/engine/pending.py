"""Future-like handles for submitted op batches (the *collect* stage).

``Engine.submit(batch)`` compiles the batch into per-shard plans and
returns a ``PendingBatch`` immediately.  Pipelined, every shard plan runs
on that shard's single-worker pool — shards execute concurrently, but
each shard sees its batches in submit order (per-shard FIFO), which is
all correctness needs: a key's whole history lives on one shard.  Serial
(``pipeline=False``), the shard plans run inline at submit time in shard
order, and collection is a no-op.  Either way the results are identical;
only the overlap differs.

Collection merges per-shard payloads back in deterministic request
order: get verdicts scatter through their op ids, and each scan's
per-shard parts are combined in ascending shard order (slab
concatenation under range partitioning, sorted-view merge under hash),
so pipelined and serial execution return byte-identical results.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from ..obs import span
from .plan import OP_GET, Plan


class PendingBatch:
    """An in-flight (or completed) submitted ``OpBatch``.

    ``wait()`` blocks until every shard plan finished and the merge-back
    ran (idempotent, thread-safe).  ``results()`` returns one slot per
    op in request order — gets yield value-or-None, range scans yield a
    sorted ``(keys, vals)`` pair, writes yield None.  ``get_results()``
    / ``scan_results()`` are the columnar accessors the typed engine
    wrappers use.  All accessors imply ``wait()``.

    Overlap contract: while a pipelined batch is in flight, submitting
    more batches is safe (per-shard FIFO), but out-of-band access to the
    engine's shards (``flush``, direct tree reads) must happen after
    ``wait()`` / ``Engine.drain()``.
    """

    def __init__(self, engine, plan: Plan, pipeline: bool):
        self.engine = engine
        self.plan = plan
        self.pipeline = pipeline
        self._t0 = time.perf_counter()
        self._io0 = engine._io_marks()
        self._futures: dict | None = None
        self._payloads: dict | None = None
        self._collected = False
        self._found: np.ndarray | None = None
        self._vals: np.ndarray | None = None
        self._scan_out: dict | None = None
        self._walls: dict[int, float] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------ launch
    def _start(self) -> None:
        active = [sp for sp in self.plan.shard_plans if sp]
        if self.pipeline:
            pools = self.engine._shard_pools()
            self._futures = {
                sp.shard: pools[sp.shard].submit(
                    self.engine.shards[sp.shard].run_plan, sp)
                for sp in active}
        else:
            self._payloads = {
                sp.shard: self.engine.shards[sp.shard].run_plan(sp)
                for sp in active}

    # ----------------------------------------------------------- collect
    def done(self) -> bool:
        """True once every shard plan has finished executing."""
        if self._futures is not None and not self._collected:
            return all(f.done() for f in self._futures.values())
        return True

    def wait(self) -> "PendingBatch":
        """Block until executed + merged; safe to call repeatedly."""
        with self._lock:
            if not self._collected:
                # The span records how many distinct devices served the
                # batch, so a trace shows whether the merge-back waited
                # on shards spread over cards or on one card.
                devs = self.engine.device_map()
                with span("engine.collect",
                          kind=self.plan.batch.kind_name,
                          batch=self.plan.seq,
                          pipelined=self.pipeline,
                          devices=len(set(devs.values()))):
                    self._collect()
                self._collected = True
        return self

    def _collect(self) -> None:
        if self._futures is not None:
            # The blocking part: waiting out the slowest shard plan.
            with span("engine.wait", batch=self.plan.seq):
                payloads = {s: f.result()
                            for s, f in self._futures.items()}
        elif self._payloads is not None:
            payloads = self._payloads
        elif not any(self.plan.shard_plans):
            payloads = {}  # empty batch: nothing was launched
        else:
            raise RuntimeError("PendingBatch collected before _start()")
        n = self.plan.n_ops
        found = np.zeros(n, dtype=bool)
        vals = np.zeros(n, dtype=np.uint64)
        scan_parts: dict[int, list] = {
            i: [] for i in self.plan.scan_ids.tolist()}
        # Ascending shard order keeps scan merge-back deterministic (and,
        # under range partitioning, already globally sorted).
        for s in sorted(payloads):
            step_payloads, wall = payloads[s]
            self._walls[s] = wall
            for payload in step_payloads:
                if payload[0] == OP_GET:
                    _, idx, f, v = payload
                    found[idx] = f
                    vals[idx] = v
                else:
                    _, idx, res = payload
                    for i, kv in zip(idx.tolist(), res):
                        scan_parts[i].append(kv)
        self._found, self._vals = found, vals
        self._scan_out = {i: self.engine._merge_scan_parts(ps)
                          for i, ps in scan_parts.items()}
        self.engine._finish_batch(self)

    # ----------------------------------------------------------- results
    def results(self) -> list:
        """One slot per op, request order (the ``execute`` contract)."""
        self.wait()
        out: list = [None] * self.plan.n_ops
        for i in self.plan.batch.get_ids.tolist():
            out[i] = int(self._vals[i]) if self._found[i] else None
        for i, kv in self._scan_out.items():
            out[i] = kv
        return out

    def get_results(self) -> tuple[np.ndarray, np.ndarray]:
        """(found mask, values) over the batch's get ops, in op order."""
        self.wait()
        gids = self.plan.batch.get_ids
        return self._found[gids], self._vals[gids]

    def scan_results(self) -> list:
        """Merged (keys, vals) per range scan op, in op order."""
        self.wait()
        return [self._scan_out[i] for i in self.plan.scan_ids.tolist()]

    @property
    def shard_walls(self) -> dict[int, float]:
        """Per-shard busy seconds (populated after ``wait``)."""
        return dict(self._walls)

    @property
    def shard_devices(self) -> dict[int, str]:
        """Home device per shard that executed this batch (the torch
        device's string, as ``Engine.device_map`` gives it)."""
        return {s: self.engine.device_map()[s] for s in self._walls}
