"""Typed op batches and the planner that compiles them per shard.

The engine's public surface is **plan -> submit -> collect**:

  ``OpBatch``    a typed, columnar batch of mixed operations — structured
                 arrays for kind/key/val/lo/hi, validated at construction
                 (replaces the ad-hoc ``("get", k)`` tuple convention),
  ``Planner``    compiles an ``OpBatch`` against a ``ShardRouter`` into
                 one ``ShardPlan`` per shard: point ops are routed
                 vectorized, range ops are clipped to the owning slabs,
                 and consecutive same-kind ops bound for the same shard
                 are grouped into one vectorized ``PlanStep``,
  ``Plan``       the compiled batch: per-shard plans plus the merge-back
                 bookkeeping (which op ids are scans, how many ops).

Plans are pure data — compiling one mutates nothing — so planning batch
n+1 can overlap executing batch n (see ``engine.pending``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from itertools import count

import numpy as np

from ..obs import span
from .router import ShardRouter

# Op kind codes (stable: these are the OpBatch column encoding).
OP_PUT = 0
OP_DELETE = 1
OP_GET = 2
OP_RANGE_DELETE = 3
OP_RANGE_SCAN = 4

KIND_NAMES = ("put", "delete", "get", "range_delete", "range_scan")
KIND_CODES = {name: code for code, name in enumerate(KIND_NAMES)}
_POINT_KINDS = (OP_PUT, OP_DELETE, OP_GET)
# Tuple arity per kind for the ``from_ops`` migration shim.
_ARITY = {OP_PUT: 3, OP_DELETE: 2, OP_GET: 2,
          OP_RANGE_DELETE: 3, OP_RANGE_SCAN: 3}


def _u64(x, n: int | None = None) -> np.ndarray:
    if x is None:
        return np.zeros(0 if n is None else n, dtype=np.uint64)
    return np.asarray(x, dtype=np.uint64)


class OpBatch:
    """A typed, columnar batch of mixed engine operations.

    Struct-of-arrays: ``kinds`` (uint8 op codes), ``keys``/``vals``
    (uint64, point ops), ``los``/``his`` (uint64, range ops).  Unused
    columns hold zeros.  Construction validates shape, kind codes, and
    range bounds once — executors and planners then trust the arrays
    and never re-inspect per-op tuples.

    Build one with the typed constructors (``OpBatch.gets(keys)``,
    ``OpBatch.puts(keys, vals)``, ``OpBatch.range_scans(ranges)``, ...),
    the mixed-stream shim ``OpBatch.from_ops([("put", k, v), ...])``, or
    directly from columns.  Batches are immutable by convention; results
    of ``Engine.submit`` align with op order (op id = row index).
    """

    __slots__ = ("kinds", "keys", "vals", "los", "his")

    def __init__(self, kinds, keys=None, vals=None, los=None, his=None):
        kinds = np.asarray(kinds, dtype=np.uint8)
        n = len(kinds)
        self.kinds = kinds
        self.keys = _u64(keys, n)
        self.vals = _u64(vals, n)
        self.los = _u64(los, n)
        self.his = _u64(his, n)
        self._validate()

    def _validate(self) -> None:
        n = len(self.kinds)
        for name in ("keys", "vals", "los", "his"):
            col = getattr(self, name)
            if col.ndim != 1 or len(col) != n:
                raise ValueError(
                    f"OpBatch.{name}: expected 1-D length {n}, "
                    f"got shape {col.shape}")
        if n and int(self.kinds.max()) > OP_RANGE_SCAN:
            bad = int(np.flatnonzero(self.kinds > OP_RANGE_SCAN)[0])
            raise ValueError(
                f"OpBatch: unknown op kind code {self.kinds[bad]} "
                f"at op {bad}")
        rng = self.kinds >= OP_RANGE_DELETE
        if rng.any():
            empty = rng & (self.los >= self.his)
            if empty.any():
                bad = int(np.flatnonzero(empty)[0])
                raise ValueError(
                    f"OpBatch: empty range [{self.los[bad]}, "
                    f"{self.his[bad]}) at op {bad} "
                    f"({KIND_NAMES[self.kinds[bad]]})")

    # ------------------------------------------------------ constructors
    @classmethod
    def puts(cls, keys, vals) -> "OpBatch":
        keys, vals = _u64(keys), _u64(vals)
        if len(keys) != len(vals):
            raise ValueError(
                f"OpBatch.puts: {len(keys)} keys vs {len(vals)} vals")
        return cls(np.full(len(keys), OP_PUT, np.uint8), keys=keys,
                   vals=vals)

    @classmethod
    def deletes(cls, keys) -> "OpBatch":
        keys = _u64(keys)
        return cls(np.full(len(keys), OP_DELETE, np.uint8), keys=keys)

    @classmethod
    def gets(cls, keys) -> "OpBatch":
        keys = _u64(keys)
        return cls(np.full(len(keys), OP_GET, np.uint8), keys=keys)

    @classmethod
    def _ranges(cls, code: int, ranges) -> "OpBatch":
        ranges = list(ranges)
        los = _u64([r[0] for r in ranges])
        his = _u64([r[1] for r in ranges])
        return cls(np.full(len(ranges), code, np.uint8), los=los, his=his)

    @classmethod
    def range_deletes(cls, ranges) -> "OpBatch":
        return cls._ranges(OP_RANGE_DELETE, ranges)

    @classmethod
    def range_scans(cls, ranges) -> "OpBatch":
        return cls._ranges(OP_RANGE_SCAN, ranges)

    @classmethod
    def from_ops(cls, ops) -> "OpBatch":
        """Migration shim from the legacy tuple stream:
        ``("put", k, v) | ("delete", k) | ("get", k) |
        ("range_delete", lo, hi) | ("range_scan", lo, hi)``."""
        n = len(ops)
        kinds = np.zeros(n, dtype=np.uint8)
        keys = np.zeros(n, dtype=np.uint64)
        vals = np.zeros(n, dtype=np.uint64)
        los = np.zeros(n, dtype=np.uint64)
        his = np.zeros(n, dtype=np.uint64)
        for i, op in enumerate(ops):
            code = KIND_CODES.get(op[0])
            if code is None:
                raise ValueError(f"unknown op kind: {op[0]!r} at op {i}")
            if len(op) != _ARITY[code]:
                raise ValueError(
                    f"op {i}: {op[0]!r} takes {_ARITY[code] - 1} "
                    f"arguments, got {len(op) - 1}")
            kinds[i] = code
            if code in _POINT_KINDS:
                keys[i] = op[1]
                if code == OP_PUT:
                    vals[i] = op[2]
            else:
                los[i], his[i] = op[1], op[2]
        return cls(kinds, keys=keys, vals=vals, los=los, his=his)

    @classmethod
    def concat(cls, batches) -> "OpBatch":
        batches = list(batches)
        if not batches:
            return cls(np.zeros(0, np.uint8))
        return cls(np.concatenate([b.kinds for b in batches]),
                   keys=np.concatenate([b.keys for b in batches]),
                   vals=np.concatenate([b.vals for b in batches]),
                   los=np.concatenate([b.los for b in batches]),
                   his=np.concatenate([b.his for b in batches]))

    # ------------------------------------------------------------- views
    def __len__(self) -> int:
        return len(self.kinds)

    @property
    def scan_ids(self) -> np.ndarray:
        """Op ids of the range scans (merge-back slots)."""
        return np.flatnonzero(self.kinds == OP_RANGE_SCAN)

    @property
    def get_ids(self) -> np.ndarray:
        """Op ids of the point gets."""
        return np.flatnonzero(self.kinds == OP_GET)

    @property
    def kind_name(self) -> str:
        """The op class: a kind name if homogeneous, else ``"mixed"``."""
        if len(self.kinds) == 0:
            return "mixed"
        k0 = int(self.kinds[0])
        if (self.kinds == k0).all():
            return KIND_NAMES[k0]
        return "mixed"

    def counts(self) -> dict:
        c = np.bincount(self.kinds, minlength=len(KIND_NAMES))
        return {name: int(c[code]) for code, name in enumerate(KIND_NAMES)
                if c[code]}

    def to_ops(self) -> list[tuple]:
        """Back to the legacy tuple stream (tests / debugging)."""
        out = []
        for i, code in enumerate(self.kinds.tolist()):
            if code == OP_PUT:
                out.append(("put", int(self.keys[i]), int(self.vals[i])))
            elif code in (OP_DELETE, OP_GET):
                out.append((KIND_NAMES[code], int(self.keys[i])))
            else:
                out.append((KIND_NAMES[code], int(self.los[i]),
                            int(self.his[i])))
        return out

    def __repr__(self) -> str:
        return f"OpBatch(n={len(self)}, {self.counts()})"


@dataclass
class PlanStep:
    """One same-kind vectorized sub-batch bound for one shard.

    ``idx`` holds the op ids (rows of the source ``OpBatch``) this step
    serves, ascending — per-shard arrival order is request order.  Point
    steps carry ``keys`` (and ``vals`` for puts); range steps carry the
    per-shard *clipped* ``los``/``his``.
    """

    kind: int
    idx: np.ndarray
    keys: np.ndarray | None = None
    vals: np.ndarray | None = None
    los: np.ndarray | None = None
    his: np.ndarray | None = None

    def __len__(self) -> int:
        return len(self.idx)


@dataclass
class ShardPlan:
    """Everything one shard executes for a batch, in request order."""

    shard: int
    steps: list[PlanStep] = field(default_factory=list)
    seq: int = -1  # owning Plan's batch number (trace correlation)

    @property
    def n_ops(self) -> int:
        return sum(len(s) for s in self.steps)

    def __bool__(self) -> bool:
        return bool(self.steps)


@dataclass
class Plan:
    """A compiled ``OpBatch``: per-shard plans + merge-back bookkeeping."""

    batch: OpBatch
    shard_plans: list[ShardPlan]
    seq: int = -1  # planner-assigned batch number (trace correlation)

    @property
    def n_ops(self) -> int:
        return len(self.batch)

    @property
    def scan_ids(self) -> np.ndarray:
        return self.batch.scan_ids


class Planner:
    """Compiles ``OpBatch``es into per-shard ``ShardPlan``s.

    Routing is columnar: one vectorized ``shard_of`` call covers every
    point op, one vectorized ``clip_ranges`` call covers every range op
    (clipping each [lo, hi) to the slabs it overlaps under range
    partitioning, broadcasting under hash).  Per shard, the op stream is
    ordered by op id and split into maximal same-kind runs — each run
    becomes one ``PlanStep``, so a shard executes exactly the vectorized
    sub-batches the old ``Engine.execute`` loop built per-op in Python.
    """

    def __init__(self, router: ShardRouter):
        self.router = router
        self._seq = count()

    def plan(self, batch: OpBatch) -> Plan:
        seq = next(self._seq)
        with span("plan.compile", kind=batch.kind_name,
                  n_ops=len(batch), batch=seq):
            return self._plan(batch, seq)

    def _plan(self, batch: OpBatch, seq: int) -> Plan:
        ns = self.router.num_shards
        kinds = batch.kinds
        point_ids = np.flatnonzero(kinds <= OP_GET)
        range_ids = np.flatnonzero(kinds >= OP_RANGE_DELETE)

        # Per-shard op ids (points) — split() is stable, ids ascend.
        if len(point_ids):
            psplit = self.router.split(batch.keys[point_ids])
        else:
            psplit = [np.zeros(0, np.int64)] * ns

        # Per-shard clipped visits (ranges), vectorized across the batch.
        rids, rshards, clos, chis = self.router.clip_ranges(
            batch.los[range_ids], batch.his[range_ids])

        plans = []
        for s in range(ns):
            oidx = point_ids[psplit[s]]
            slo = shi = None
            vm = rshards == s
            if vm.any():
                v_ids = range_ids[rids[vm]]
                oidx = np.concatenate([oidx, v_ids])
                slo = np.concatenate(
                    [np.zeros(len(oidx) - len(v_ids), np.uint64),
                     clos[vm]])
                shi = np.concatenate(
                    [np.zeros(len(oidx) - len(v_ids), np.uint64),
                     chis[vm]])
                order = np.argsort(oidx, kind="stable")
                oidx, slo, shi = oidx[order], slo[order], shi[order]
            plans.append(self._shard_plan(s, batch, oidx, slo, shi))
        for sp in plans:
            sp.seq = seq
        return Plan(batch=batch, shard_plans=plans, seq=seq)

    def _shard_plan(self, s: int, batch: OpBatch, oidx: np.ndarray,
                    slo, shi) -> ShardPlan:
        """Split one shard's ordered op-id stream into vectorized steps.

        Writes split on every kind change (their relative order is the
        semantics).  Reads are scheduled dependency-aware: a get or a
        range scan commutes with every other read, and it commutes with
        an intervening *write* as long as the write does not touch its
        key(s) — a range delete over a cold slab cannot change what a
        hot get observes.  The planner therefore keeps one *open read
        slot* and hoists each arriving read into it unless the read
        overlaps a write accumulated since the slot opened; a
        conflicting read closes the slot (materializing at most one
        batched-get step and one batched-scan step at its position) and
        opens a fresh slot after the writes.  Mixed streams thus compile
        to a few large read sub-batches — big enough to amortize kernel
        launches — while every read still observes exactly the writes
        its results depend on.
        """
        sp = ShardPlan(shard=s)
        if len(oidx) == 0:
            return sp
        k = batch.kinds[oidx]
        wr = (k != OP_GET) & (k != OP_RANGE_SCAN)
        brk = (wr[1:] != wr[:-1]) | (wr[1:] & (k[1:] != k[:-1]))
        bounds = np.concatenate(
            [[0], np.flatnonzero(brk) + 1, [len(k)]])

        items: list = []  # PlanStep (writes) | dict (open read slots)
        slot: dict | None = None

        def open_slot() -> dict:
            # gets/scans accumulate op ids (+ scan bounds); wlo/whi and
            # wkeys are the ranges/keys written since the slot opened.
            s_ = {"gets": [], "scans": [], "wlo": [], "whi": [],
                  "wkeys": []}
            items.append(s_)
            return s_

        for a, b in zip(bounds[:-1].tolist(), bounds[1:].tolist()):
            kind = int(k[a])
            idx = oidx[a:b]
            if wr[a]:
                if kind in _POINT_KINDS:
                    items.append(PlanStep(
                        kind=kind, idx=idx, keys=batch.keys[idx],
                        vals=batch.vals[idx] if kind == OP_PUT else None))
                    if slot is not None:
                        slot["wkeys"].append(batch.keys[idx])
                else:
                    items.append(PlanStep(
                        kind=kind, idx=idx, los=slo[a:b], his=shi[a:b]))
                    if slot is not None:
                        slot["wlo"].append(slo[a:b])
                        slot["whi"].append(shi[a:b])
                continue
            if slot is None:
                slot = open_slot()
            gets = idx[k[a:b] == OP_GET]
            sm = k[a:b] == OP_RANGE_SCAN
            scans = (idx[sm], slo[a:b][sm], shi[a:b][sm]) \
                if sm.any() else None
            g_conf, s_conf = self._read_conflicts(batch, slot, gets,
                                                  scans)
            if len(gets):
                slot["gets"].append(gets[~g_conf])
            if scans is not None:
                slot["scans"].append(tuple(x[~s_conf] for x in scans))
            if g_conf.any() or (s_conf is not None and s_conf.any()):
                # Conflicting reads must observe the writes: close the
                # slot and start a fresh one after them.
                slot = open_slot()
                if g_conf.any():
                    slot["gets"].append(gets[g_conf])
                if s_conf is not None and s_conf.any():
                    slot["scans"].append(tuple(x[s_conf] for x in scans))

        for item in items:
            if isinstance(item, PlanStep):
                sp.steps.append(item)
                continue
            gids = [g for g in item["gets"] if len(g)]
            if gids:
                gid = np.concatenate(gids)
                sp.steps.append(PlanStep(kind=OP_GET, idx=gid,
                                         keys=batch.keys[gid]))
            sids = [t for t in item["scans"] if len(t[0])]
            if sids:
                sp.steps.append(PlanStep(
                    kind=OP_RANGE_SCAN,
                    idx=np.concatenate([t[0] for t in sids]),
                    los=np.concatenate([t[1] for t in sids]),
                    his=np.concatenate([t[2] for t in sids])))
        return sp

    @staticmethod
    def _read_conflicts(batch: OpBatch, slot: dict, gets: np.ndarray,
                        scans):
        """Which of a read segment's ops overlap the slot's writes.

        A get conflicts if a write range covers its key or a written key
        equals it; a scan conflicts if a write range overlaps [lo, hi)
        or a written key falls inside it.  Everything else is safe to
        hoist into the open slot (the writes cannot change its result).
        """
        wlo = np.concatenate(slot["wlo"]) if slot["wlo"] else None
        wk = np.concatenate(slot["wkeys"]) if slot["wkeys"] else None
        g_conf = np.zeros(len(gets), dtype=bool)
        if len(gets):
            keys = batch.keys[gets]
            if wlo is not None:
                whi = np.concatenate(slot["whi"])
                g_conf |= ((keys[:, None] >= wlo[None, :]) &
                           (keys[:, None] < whi[None, :])).any(axis=1)
            if wk is not None:
                g_conf |= np.isin(keys, wk)
        if scans is None:
            return g_conf, None
        _, alos, ahis = scans
        s_conf = np.zeros(len(alos), dtype=bool)
        if wlo is not None:
            whi = np.concatenate(slot["whi"])
            s_conf |= ((alos[:, None] < whi[None, :]) &
                       (ahis[:, None] > wlo[None, :])).any(axis=1)
        if wk is not None:
            s_conf |= ((wk[None, :] >= alos[:, None]) &
                       (wk[None, :] < ahis[:, None])).any(axis=1)
        return g_conf, s_conf
