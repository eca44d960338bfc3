"""Background delete-aware flush/compaction scheduling (Lethe-style).

The inline write path stalls the serving thread every time a memtable
fills: ``LSMTree.flush`` runs the whole flush + leveled-compaction
cascade synchronously.  With a ``CompactionScheduler`` attached, the
tree instead **seals** the full memtable into an immutable frozen
snapshot (``FrozenMemtable`` — the cached sorted columnar view, zero
copy work beyond what a read batch already paid) and returns; the
heavy lifting becomes *jobs* on a priority queue that the execution
layer drains at deterministic points (the start of every shard plan,
and every explicit ``drain``/``flush``/``close``/``stats``).

Running jobs only at those points — never on an opportunistic side
thread — is what keeps the background mode byte-identical to the
inline path for any sequence of engine calls: every plan begins from
exactly the state the inline path would have reached, and every I/O
charge lands on the same ledger before the next observation point.
What moves is latency *attribution*: a put batch no longer carries the
flush + cascade on its own wall clock.  A job's compactions order their
merges through the tree's ``compaction_rank_fn`` (the shard's
merge-rank kernel hook) on whichever thread runs the job, so every
launch stays on the shard's device.

Job classes, in heap priority order:

  0  CASCADE    capacity-driven compaction of an overflowing level —
                the barrier children of the flush that overflowed it
                (the inline path runs them immediately after the flush,
                and so do we: at most one level overflows at a time, so
                any within-class order reproduces the inline cascade),
  1  FLUSH      one frozen memtable -> a level-0 run, FIFO,
  2  PROACTIVE  delete-aware compactions scored by
                ``(-range_tombstone_density, -level_overflow_ratio)``
                (Lethe: evict tombstone-dense runs first).  Enabled
                only when ``tombstone_trigger`` is set; a level whose
                estimated density reaches the trigger is compacted
                down even though it has not overflowed, so GLORAN
                garbage (and the DeviceFilterRegistry re-uploads its
                growing index causes) is reclaimed early instead of at
                an arbitrary overflow moment.

Density per level: LRR counts its range-tombstone block directly
(``len(level_rts[i]) / len(level_i)``); GLORAN asks the paper's own
estimator — a deterministic evenly-spaced sample of the level's
(key, seq) pairs probed through EVE — for the fraction of entries a
live range delete maybe-covers.  A (level uid, range-delete count)
stamp on proactive outputs stops EVE's false-positive floor from
re-triggering on a run we just compacted.

Backpressure: sealing past ``max_frozen`` pending snapshots runs due
jobs on the sealing thread until the backlog is back under the soft
limit, counted as a stall (``stall_count`` / ``stall_seconds`` and a
``sched.stall`` span) — the only point where a put can block on
compaction debt.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from dataclasses import dataclass, field

import numpy as np

from ..obs import span
from .sstable import RangeTombstoneBlock

# Job classes (heap key element 0).
JOB_CASCADE = 0    # capacity-driven compaction (barrier child of a flush)
JOB_FLUSH = 1      # frozen memtable -> level 0
JOB_PROACTIVE = 2  # delete-aware compaction (Lethe scoring)

_PROACTIVE_SAMPLE = 256  # EVE probes per level-density estimate
_PROACTIVE_PER_KICK = 4  # proactive compactions per drain point


@dataclass
class FrozenMemtable:
    """One sealed, immutable memtable: the key-sorted columnar snapshot
    (unique keys — the dict semantics already resolved overwrites) plus
    the LRR range-tombstone buffer that sealed with it."""

    keys: np.ndarray
    seqs: np.ndarray
    types: np.ndarray
    vals: np.ndarray
    rts: list = field(default_factory=list)  # [(lo, hi, seq)] (LRR)
    # ``rts`` as one block, built by the first LRR get that reads it and
    # kept (the snapshot is immutable) until the flush drops it.
    rt_blk: RangeTombstoneBlock | None = field(default=None, repr=False,
                                               compare=False)

    @property
    def min_seq(self) -> int:
        return int(self.seqs.min()) if len(self.seqs) else 0

    def __len__(self) -> int:
        return len(self.keys)


def level_rt_density(tree, i: int) -> float:
    """Estimated fraction of level ``i``'s entries covered by a live
    range tombstone — the scheduler's Lethe priority input, also
    surfaced per level in ``engine.stats()``.

    LRR: exact ratio of the level's range-tombstone block to its run.
    GLORAN: EVE-sampled — probe an evenly-spaced deterministic sample
    of the level's (key, seq) pairs through the estimator (no I/O; the
    estimator is the in-memory structure the paper builds for exactly
    this maybe-deleted question) and return the maybe-covered fraction.
    Other strategies carry no range-tombstone metadata: 0.0.
    """
    lvl = tree.levels[i] if i < len(tree.levels) else None
    n = len(lvl) if lvl is not None else 0
    if tree.strategy == "lrr":
        nrt = len(tree.level_rts[i]) if i < len(tree.level_rts) else 0
        return nrt / max(n, 1)
    if tree.strategy == "gloran" and tree.gloran is not None and n:
        gl = tree.gloran
        if gl.num_range_deletes == 0 or gl.eve is None:
            return 0.0
        m = min(n, _PROACTIVE_SAMPLE)
        idx = np.linspace(0, n - 1, m).astype(np.int64)
        maybe = gl.eve.maybe_deleted_batch(lvl.keys[idx], lvl.seqs[idx])
        return float(np.mean(maybe))
    return 0.0


class CompactionScheduler:
    """Per-shard background flush/compaction job queue (see module doc).

    Owned by one shard's tree + executor; ``run_due`` executes every
    queued job (and any proactive candidates) on the calling thread.
    The run lock only guards against overlapping drain points (e.g. an
    engine-level ``drain`` racing a shard worker's plan-start kick);
    within the per-shard FIFO there is no concurrency to manage.
    """

    def __init__(self, tree, *, max_frozen: int = 4,
                 tombstone_trigger: float | None = None):
        self.tree = tree
        self.max_frozen = max(1, int(max_frozen))
        self.tombstone_trigger = tombstone_trigger
        self._heap: list[tuple] = []
        self._tick = itertools.count()
        self._run_lock = threading.RLock()
        # (level uid -> range-delete count at stamp time): proactive
        # outputs are not re-candidates until new range deletes arrive,
        # which caps the estimator's false-positive floor at one
        # compaction instead of an unbounded walk down the tree.
        self._proactive_stamp: dict[int, int] = {}
        self._proactive_seen = (-1, -1)  # (rdel count, struct epoch)
        # Counters (surfaced as ``sched.*`` metrics).
        self.flush_jobs = 0
        self.cascade_jobs = 0
        self.proactive_jobs = 0
        self.stall_count = 0
        self.stall_seconds = 0.0
        self.max_queue_depth = 0

    # ------------------------------------------------------------ queue
    def _push(self, klass: int, score, kind: str, level: int) -> None:
        heapq.heappush(self._heap, (klass, score, next(self._tick),
                                    kind, level))
        self.max_queue_depth = max(self.max_queue_depth, len(self._heap))

    def queue_depth(self) -> int:
        return len(self._heap)

    def compaction_debt(self) -> int:
        """Pending background work: queued jobs + unflushed snapshots."""
        return len(self._heap) + len(self.tree.frozen)

    def has_work(self) -> bool:
        return bool(self._heap) or bool(self.tree.frozen) or \
            self._proactive_due()

    # ------------------------------------------------------------ seal
    def on_seal(self) -> None:
        """A memtable was just frozen: enqueue its flush; apply the
        soft-limit backpressure if the backlog is past ``max_frozen``."""
        self._push(JOB_FLUSH, 0.0, "flush", -1)
        if len(self.tree.frozen) > self.max_frozen:
            t0 = time.perf_counter()
            with span("sched.stall", frozen=len(self.tree.frozen),
                      limit=self.max_frozen):
                while (self.tree.frozen and
                       len(self.tree.frozen) > self.max_frozen):
                    if not self._run_one():
                        break
            self.stall_count += 1
            self.stall_seconds += time.perf_counter() - t0

    # ------------------------------------------------------- execution
    def run_due(self) -> int:
        """Execute every queued job plus due proactive compactions.

        Called at the deterministic drain points (plan start, engine
        drain/flush/close/stats).  Returns the number of jobs run.
        """
        if not self._heap and not self._proactive_due():
            return 0
        ran = 0
        with self._run_lock:
            while self._run_one():
                ran += 1
            ran += self._run_proactive()
        return ran

    def drain(self) -> int:
        """Synchronously run until no queued work remains (explicit
        flush/close semantics)."""
        with self._run_lock:
            ran = self.run_due()
            # A flush can enqueue cascades; loop until quiescent.
            while self._heap:
                ran += self.run_due()
        return ran

    def _run_one(self) -> bool:
        """Pop and execute the highest-priority job; False when idle."""
        with self._run_lock:
            if not self._heap:
                return False
            _, _, _, kind, level = heapq.heappop(self._heap)
            if kind == "flush":
                self._job_flush()
            else:
                self._job_compact(level, kind)
            return True

    def _job_flush(self) -> None:
        tree = self.tree
        if not tree.frozen:
            return
        fz = tree.frozen[0]
        with span("sched.flush", entries=len(fz),
                  range_tombstones=len(fz.rts),
                  backlog=len(tree.frozen)):
            tree._flush_frozen_one()
        self.flush_jobs += 1
        self._enqueue_overflows()

    def _job_compact(self, level: int, kind: str) -> None:
        tree = self.tree
        if level >= len(tree.levels):
            return
        lvl = tree.levels[level]
        if lvl is None or len(lvl) == 0:
            return
        over = len(lvl) > tree.config.level_capacity(level)
        if kind == "cascade" and not over:
            return  # stale: another job already compacted it
        with span("sched.compact", level=level, entries=len(lvl),
                  reason=kind):
            tree._compact(level)
        if kind == "cascade":
            self.cascade_jobs += 1
        else:
            self.proactive_jobs += 1
            merged = (tree.levels[level + 1]
                      if level + 1 < len(tree.levels) else None)
            if merged is not None and len(merged):
                self._proactive_stamp[merged.uid] = self._rdel_count()
        self._enqueue_overflows()

    def _enqueue_overflows(self) -> None:
        """Queue a CASCADE job per overflowing level (ascending, like
        the inline cascade; in practice at most one level overflows at
        any instant, so the order is forced either way)."""
        tree = self.tree
        queued = {(e[3], e[4]) for e in self._heap}
        for i, lvl in enumerate(tree.levels):
            if lvl is not None and len(lvl) > tree.config.level_capacity(i):
                if ("cascade", i) not in queued:
                    ratio = len(lvl) / tree.config.level_capacity(i)
                    self._push(JOB_CASCADE, (float(i), -ratio),
                               "cascade", i)

    # ------------------------------------------------------- proactive
    def _rdel_count(self) -> int:
        tree = self.tree
        if tree.strategy == "gloran" and tree.gloran is not None:
            return int(tree.gloran.num_range_deletes)
        if tree.strategy == "lrr":
            return int(sum(len(r) for r in tree.level_rts) +
                       len(tree.mem_rts) +
                       sum(len(f.rts) for f in tree.frozen))
        return 0

    def _proactive_due(self) -> bool:
        """Cheap gate: only re-evaluate densities when range deletes or
        the level structure moved since the last evaluation."""
        if self.tombstone_trigger is None:
            return False
        now = (self._rdel_count(), self.tree.struct_epoch)
        return now != self._proactive_seen

    def _run_proactive(self) -> int:
        if not self._proactive_due():
            return 0
        tree = self.tree
        ran = 0
        for _ in range(_PROACTIVE_PER_KICK):
            best = None
            rdels = self._rdel_count()
            for i, lvl in enumerate(tree.levels):
                if lvl is None or len(lvl) == 0:
                    continue
                if self._proactive_stamp.get(lvl.uid) == rdels:
                    continue  # our own output; no new deletes since
                density = level_rt_density(tree, i)
                if density < self.tombstone_trigger:
                    continue
                ratio = len(lvl) / tree.config.level_capacity(i)
                score = (-density, -ratio)
                if best is None or score < best[0]:
                    best = (score, i)
            if best is None:
                break
            self._push(JOB_PROACTIVE, best[0], "proactive", best[1])
            self._run_one()
            ran += 1
        self._proactive_seen = (self._rdel_count(), tree.struct_epoch)
        return ran

    # ------------------------------------------------------------ misc
    def counters(self) -> dict:
        return {
            "flush_jobs": self.flush_jobs,
            "cascade_jobs": self.cascade_jobs,
            "proactive_jobs": self.proactive_jobs,
            "stall_count": self.stall_count,
            "stall_seconds": round(self.stall_seconds, 6),
            "queue_depth": len(self._heap),
            "max_queue_depth": self.max_queue_depth,
            "frozen": len(self.tree.frozen),
            "compaction_debt": self.compaction_debt(),
        }
