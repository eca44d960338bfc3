"""Process-parallel shard execution over shared-memory columnar rings.

The GIL serializes pure-host numpy work (routing, memtable
searchsorted, merge-back, staging folds), so pipelined *threads* buy
nothing on compute-bound hosts.  This module moves each shard's
``LSMTree`` + ``ShardExecutor`` into a **worker process** and ships
``ShardPlan``s to it over ``multiprocessing.shared_memory`` as raw
OpBatch columns — no pickle anywhere on the hot path.

Workers start with the ``spawn`` method (CUDA cannot be forked).  Each
holds a CUDA context of its own on its shards' home devices and
launches the store's kernels there; a worker that cannot reach its
device, or whose kernel fails to build or launch, fails its request
(``MSG_ERR`` -> ``RuntimeError`` in the parent), with no fallback.
``native.LAUNCHES`` is per process, so the parent reads the workers'
counts through ``ProcPool.launches()``.

Transport
---------
Each worker owns two SPSC byte rings (one shm segment per direction)
plus two one-way pipes carrying fixed-size tokens.  A ring frame is

    RING_HEADER ("<IBQ": payload_len u32 | mtype u8 | seq u64) | payload

— the WAL frame discipline from ``durable/wal.py`` (length prefix,
type byte, sequence number) minus the crc: the pipe token *is* the
integrity check, naming the exact (mtype, seq, offset, length) the
receiver must find at that ring position.  Frames never wrap: a writer
that would cross the ring edge pads to it and starts at offset 0, so
every payload is one contiguous slice (zero-copy ``np.frombuffer``
decodes).  The reader publishes a consumed watermark (absolute byte
offset, first 8 bytes of the segment); the writer blocks when
``written - consumed`` would exceed capacity.

A plan request's payload is the columnar wire image of the shard plan:

    PLAN_HEADER | step_kinds u8[n_steps] | step_lens u32[n_steps]
                | keys u64[n] | vals u64[n] | los u64[n] | his u64[n]

exactly the arrays a WAL BATCH frame carries, plus step boundaries so
the worker rebuilds the same ``PlanStep`` run structure the planner
emitted.  The reply ships result columns (found/vals for gets,
length-prefixed sorted runs for scans) plus a small JSON aux blob with
the shard's cumulative IOStats / entries / KernelCounters snapshot —
cumulative, not deltas, so the parent's mirrors are **idempotent**
(absorbing the same reply twice cannot double-count).

Ordering / durability invariants (all preserved from the in-process
path): one request pipe per worker + a single-threaded worker loop
gives per-shard FIFO; the worker's ``ShardExecutor`` appends the plan
to its own WAL stream *before* executing it, and the reply token is the
ack — WAL-append-before-ack holds exactly as in-process.  Structure
edits (flush/compaction/GC) are shipped back as described level records
and replayed into the parent's manifest in reply order.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import time
import traceback
from dataclasses import dataclass, replace
from multiprocessing import shared_memory

import numpy as np

from .plan import OP_GET, OP_PUT, OP_RANGE_SCAN, PlanStep, ShardPlan

# ---------------------------------------------------------------- wire

# Pipe token: mtype u8 | seq u64 | ring offset u64 | total length u64 |
# send timestamp f64 (perf_counter — CLOCK_MONOTONIC, comparable across
# processes on Linux, feeding the enqueue->dequeue latency histogram).
TOKEN = struct.Struct("<BQQQd")
# Ring frame prefix: payload_len u32 | mtype u8 | seq u64 (the WAL
# frame-header discipline; crc is replaced by the token cross-check).
RING_HEADER = struct.Struct("<IBQ")
# Plan request: shard u32 | plan seq i64 | n ops u32 | n steps u32 |
# flags u8 (bit0 = tracing on: ship spans back with the reply).
PLAN_HEADER = struct.Struct("<IqIIB")
# Plan reply: shard u32 | plan seq i64 | shard wall f64 |
# n payloads u32 | aux (JSON) length u32.
REP_HEADER = struct.Struct("<IqdII")
# Per-payload prefix inside a reply: op kind u8 | n rows u32.
PAYLOAD_HEADER = struct.Struct("<BI")

MSG_PLAN = 1
MSG_FLUSH = 2
MSG_SCHED = 3
MSG_STATS = 4
MSG_CLOSE = 5
MSG_ERR = 6
MSG_LAUNCHES = 7

FLAG_TRACE = 1


class ShmRing:
    """Single-producer single-consumer byte ring over one shm segment.

    Layout: 16-byte header (consumed watermark u64 at [0:8], written by
    the *reader*; [8:16] reserved) followed by ``capacity`` data bytes.
    Offsets are absolute monotonic byte counters; ``abs % capacity``
    maps into the data region.  Frames are contiguous (pad-to-edge on
    wrap), so a reader always gets one flat slice.
    """

    HDR = 16

    def __init__(self, capacity: int = 0, *, name: str | None = None,
                 create: bool = False):
        if create:
            self.shm = shared_memory.SharedMemory(
                create=True, size=self.HDR + int(capacity))
            self.shm.buf[:self.HDR] = b"\x00" * self.HDR
            self._owner = True
        else:
            self.shm = shared_memory.SharedMemory(name=name)
            self._owner = False
        self.capacity = self.shm.size - self.HDR
        self.written = 0        # writer-local absolute byte counter

    @property
    def name(self) -> str:
        return self.shm.name

    # Reader side -----------------------------------------------------
    def consume_to(self, abs_off: int, total: int) -> None:
        """Publish that everything up to the end of the frame at
        ``abs_off`` has been copied out (covers any pad before it)."""
        self.shm.buf[0:8] = int(abs_off + total).to_bytes(8, "little")

    def read(self, abs_off: int, total: int, mtype: int,
             seq: int) -> bytes:
        """Copy one frame's payload out of the ring, cross-checking the
        ring header against the token that named it."""
        pos = self.HDR + (abs_off % self.capacity)
        raw = bytes(self.shm.buf[pos:pos + total])
        plen, mt, sq = RING_HEADER.unpack_from(raw, 0)
        if (mt, sq, plen) != (mtype, seq, total - RING_HEADER.size):
            raise RuntimeError(
                f"shm ring corruption at offset {abs_off}: frame header "
                f"(type={mt}, seq={sq}, len={plen}) does not match token "
                f"(type={mtype}, seq={seq}, len={total - RING_HEADER.size})")
        return raw[RING_HEADER.size:]

    # Writer side -----------------------------------------------------
    def _consumed(self) -> int:
        return int.from_bytes(bytes(self.shm.buf[0:8]), "little")

    def _wait_space(self, upto: int) -> None:
        while upto - self._consumed() > self.capacity:
            time.sleep(20e-6)

    def write(self, mtype: int, seq: int,
              parts: list[bytes]) -> tuple[int, int]:
        """Append one frame; returns its (absolute offset, total length)
        for the pipe token.  Blocks while the ring is full."""
        payload_len = sum(len(p) for p in parts)
        total = RING_HEADER.size + payload_len
        if total > self.capacity:
            raise RuntimeError(
                f"plan frame of {total} bytes exceeds the shm ring "
                f"capacity ({self.capacity}); raise "
                "EngineConfig.proc_ring_bytes or split the batch")
        pos = self.written % self.capacity
        if pos + total > self.capacity:     # pad to edge, never wrap
            self.written += self.capacity - pos
            pos = 0
        self._wait_space(self.written + total)
        off = self.HDR + pos
        buf = self.shm.buf
        buf[off:off + RING_HEADER.size] = RING_HEADER.pack(
            payload_len, mtype, seq)
        at = off + RING_HEADER.size
        for p in parts:
            buf[at:at + len(p)] = p
            at += len(p)
        abs_off = self.written
        self.written += total
        return abs_off, total

    # Lifecycle -------------------------------------------------------
    def close(self) -> None:
        try:
            self.shm.close()
        except (OSError, BufferError):
            pass

    def unlink(self) -> None:
        if self._owner:
            try:
                self.shm.unlink()
            except (OSError, FileNotFoundError):
                pass


# ------------------------------------------------------ plan encoding

def encode_plan(shard: int, sp: ShardPlan, flags: int) -> list[bytes]:
    """Flatten a ShardPlan into the columnar wire image (see module
    docstring).  ``idx`` is NOT shipped — positions are implied by step
    order, and the parent re-associates replies with its own plan."""
    n = sp.n_ops
    n_steps = len(sp.steps)
    step_kinds = np.empty(n_steps, np.uint8)
    step_lens = np.empty(n_steps, np.uint32)
    keys = np.zeros(n, np.uint64)
    vals = np.zeros(n, np.uint64)
    los = np.zeros(n, np.uint64)
    his = np.zeros(n, np.uint64)
    o = 0
    for i, st in enumerate(sp.steps):
        ln = len(st)
        step_kinds[i] = st.kind
        step_lens[i] = ln
        if st.keys is not None:
            keys[o:o + ln] = st.keys
        if st.vals is not None:
            vals[o:o + ln] = st.vals
        if st.los is not None:
            los[o:o + ln] = st.los
            his[o:o + ln] = st.his
        o += ln
    return [PLAN_HEADER.pack(int(shard), int(sp.seq), n, n_steps, flags),
            step_kinds.tobytes(), step_lens.tobytes(), keys.tobytes(),
            vals.tobytes(), los.tobytes(), his.tobytes()]


def decode_plan(payload: bytes) -> tuple[ShardPlan, int]:
    """Worker-side inverse of ``encode_plan`` (synthesizes positional
    ``idx`` runs; the parent never sees them)."""
    shard, seq, n, n_steps, flags = PLAN_HEADER.unpack_from(payload, 0)
    at = PLAN_HEADER.size
    step_kinds = np.frombuffer(payload, np.uint8, n_steps, at)
    at += n_steps
    step_lens = np.frombuffer(payload, np.uint32, n_steps, at)
    at += 4 * n_steps
    cols = []
    for _ in range(4):
        cols.append(np.frombuffer(payload, np.uint64, n, at).copy())
        at += 8 * n
    keys, vals, los, his = cols
    steps, o = [], 0
    for k, ln in zip(step_kinds.tolist(), step_lens.tolist()):
        idx = np.arange(o, o + ln, dtype=np.int64)
        if k in (OP_RANGE_SCAN, 3):                 # OP_RANGE_DELETE = 3
            steps.append(PlanStep(kind=int(k), idx=idx,
                                  los=los[o:o + ln], his=his[o:o + ln]))
        else:
            steps.append(PlanStep(
                kind=int(k), idx=idx, keys=keys[o:o + ln],
                vals=vals[o:o + ln] if k == OP_PUT else None))
        o += ln
    return ShardPlan(shard=int(shard), steps=steps, seq=int(seq)), flags


def encode_reply(shard: int, seq: int, wall: float, payloads: list,
                 aux: dict) -> list[bytes]:
    parts: list[bytes] = []
    for pl in payloads:
        if pl[0] == OP_GET:
            _, _idx, found, vals = pl
            parts.append(PAYLOAD_HEADER.pack(OP_GET, len(found)))
            parts.append(np.ascontiguousarray(
                found, dtype=np.uint8).tobytes())
            parts.append(np.ascontiguousarray(
                vals, dtype=np.uint64).tobytes())
        else:
            _, _idx, results = pl
            lens = np.fromiter((len(k) for k, _v in results),
                               np.uint32, len(results))
            parts.append(PAYLOAD_HEADER.pack(OP_RANGE_SCAN, len(results)))
            parts.append(lens.tobytes())
            for k, v in results:
                parts.append(np.ascontiguousarray(k, np.uint64).tobytes())
                parts.append(np.ascontiguousarray(v, np.uint64).tobytes())
    auxb = json.dumps(aux, default=str).encode()
    head = REP_HEADER.pack(int(shard), int(seq), float(wall),
                           len(payloads), len(auxb))
    return [head, *parts, auxb]


def decode_reply(data: bytes,
                 result_steps: list[PlanStep]) -> tuple[list, float, dict]:
    """Parent-side inverse: rebuild the payload contract the collector
    expects, re-attaching the parent plan's own ``idx`` arrays (replies
    arrive in step order — the worker executes steps in order)."""
    shard, seq, wall, n_payloads, aux_len = REP_HEADER.unpack_from(data, 0)
    at = REP_HEADER.size
    payloads = []
    for i in range(n_payloads):
        kind, n = PAYLOAD_HEADER.unpack_from(data, at)
        at += PAYLOAD_HEADER.size
        st = result_steps[i]
        if kind == OP_GET:
            found = np.frombuffer(data, np.uint8, n, at).astype(bool)
            at += n
            vals = np.frombuffer(data, np.uint64, n, at).copy()
            at += 8 * n
            payloads.append((OP_GET, st.idx, found, vals))
        else:
            lens = np.frombuffer(data, np.uint32, n, at)
            at += 4 * n
            results = []
            for ln in lens.tolist():
                k = np.frombuffer(data, np.uint64, ln, at).copy()
                at += 8 * ln
                v = np.frombuffer(data, np.uint64, ln, at).copy()
                at += 8 * ln
                results.append((k, v))
            payloads.append((OP_RANGE_SCAN, st.idx, results))
    aux = json.loads(data[at:at + aux_len]) if aux_len else {}
    return payloads, float(wall), aux


# ---------------------------------------------------------- wal locks

def _acquire_stream_lock(wal_dir: str, shard: int, owner: str) -> str:
    """Exclusive per-stream lockfile (O_CREAT|O_EXCL): two workers —
    or two engines — claiming the same WAL stream is a configuration
    error that would interleave their frames, so fail fast and name the
    holder.  A lock whose pid is dead is stolen (crashed owner)."""
    from ..durable.wal import shard_dir
    d = shard_dir(wal_dir, shard)
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "LOCK")
    body = f"{os.getpid()} {owner}".encode()
    while True:
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            os.write(fd, body)
            os.close(fd)
            return path
        except FileExistsError:
            try:
                pid = int(open(path).read().split()[0])
            except (ValueError, IndexError, OSError):
                pid = 0
            if pid and _pid_alive(pid):
                raise RuntimeError(
                    f"WAL stream shard-{shard:03d} under {wal_dir} is "
                    f"already owned by live process {pid}; two workers "
                    "sharing one wal_dir stream would interleave frames "
                    "— give each engine its own wal_dir") from None
            try:                         # stale lock: owner is gone
                os.unlink(path)
            except FileNotFoundError:
                pass


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


class _StructureSink:
    """Worker-side stand-in for the parent's LevelManifest: buffers
    described structural edits (flush/compaction/GC level records) so
    each reply ships them home, where they replay into the real
    manifest in ack order."""

    def __init__(self):
        self.pending: list[tuple[dict, str]] = []

    def record_structure(self, shard: int, tree, *, reason: str) -> int:
        from ..durable.manifest import describe_tree
        self.pending.append((describe_tree(tree), reason))
        return len(self.pending)

    def drain(self) -> list[list]:
        out, self.pending = self.pending, []
        return [[d, r] for d, r in out]


# --------------------------------------------------------- worker side

@dataclass
class WorkerSpec:
    """Everything a spawned worker needs to rebuild its shard slab —
    pickled once at spawn (flat dataclasses + primitives only; the
    spawn-safety test round-trips it)."""

    worker_id: int
    shard_ids: tuple
    device_ids: tuple           # torch device of each shard ("cuda:0")
    strategy: str
    lsm_config: object          # LSMConfig
    gloran_config: object       # GloranConfig | None
    engine_config: object       # EngineConfig (procs/wal_dir cleared)
    background: bool
    wal_dir: str | None
    replay: bool                # replay existing frames before serving
    trace: bool


class _WorkerHost:
    """Owns the worker's executors; dispatches decoded messages."""

    def __init__(self, spec: WorkerSpec):
        from ..device import resolve_device
        from ..lsm import LSMTree
        from ..lsm.scheduler import CompactionScheduler
        from .executor import ShardExecutor
        if spec.trace:
            from ..obs.tracer import Tracer, set_tracer, tracing_enabled
            if not tracing_enabled():
                set_tracer(Tracer())
        cfg = spec.engine_config
        self.spec = spec
        self.executors: dict[int, object] = {}
        self.sinks: dict[int, _StructureSink] = {}
        self.locks: list[str] = []
        self.ready_info: dict[int, dict] = {}
        for s, dev_id in zip(spec.shard_ids, spec.device_ids):
            tree = LSMTree(spec.lsm_config, strategy=spec.strategy,
                           gloran_config=spec.gloran_config)
            ex = ShardExecutor(tree, cfg, resolve_device(dev_id))
            if spec.background:
                ex.attach_scheduler(CompactionScheduler(
                    tree, max_frozen=cfg.max_frozen,
                    tombstone_trigger=cfg.tombstone_trigger))
            info = {"frames": 0, "desc": None}
            if spec.wal_dir:
                from ..durable.manifest import describe_tree
                from ..durable.wal import WalReader, WalWriter, shard_dir
                frames = []
                if spec.replay:
                    from ..durable.recovery import replay_frame
                    t0 = time.perf_counter()
                    reader = WalReader(spec.wal_dir, s)
                    frames = reader.read_frames()
                    reader.truncate_torn_tail()
                    t1 = time.perf_counter()
                    for fr in frames:
                        replay_frame(ex, fr)
                    ex.run_scheduler("recover")
                    info["frames"] = len(frames)
                    info["desc"] = describe_tree(tree)
                    # Port-only timing: reading the stream, replaying it.
                    info["read_s"] = t1 - t0
                    info["replay_s"] = time.perf_counter() - t1
                self.locks.append(
                    _acquire_stream_lock(spec.wal_dir, s,
                                         f"worker-{spec.worker_id}"))
                w = WalWriter(spec.wal_dir, s,
                              segment_bytes=cfg.wal_segment_bytes,
                              fsync=cfg.fsync)
                if frames:
                    # Position at the durable tail: appends continue
                    # the stream, rotation accounting stays exact.
                    w.frames_appended = len(frames)
                    d = shard_dir(spec.wal_dir, s)
                    w.bytes_written = sum(
                        os.path.getsize(os.path.join(d, f))
                        for f in os.listdir(d)
                        if f.startswith("seg-") and f.endswith(".wal"))
                sink = _StructureSink()
                ex.attach_durability(w, sink, s)
                self.sinks[s] = sink
            self.executors[s] = ex
            self.ready_info[s] = info
        # The READY handshake carries each shard's ledgers, so the
        # parent's mirrors are right before the first request (a
        # recovered shard starts with entries).
        for s, info in self.ready_info.items():
            info["aux"] = self._aux(s)

    # Aux blob shipped with every reply: CUMULATIVE shard ledgers (the
    # parent overwrites its mirrors — idempotent by construction).
    def _aux(self, shard: int, extra: dict | None = None) -> dict:
        ex = self.executors[shard]
        aux = {
            "io": [int(ex.tree.io.reads), int(ex.tree.io.writes)],
            "entries": int(ex.tree.num_entries),
            "kernels": ex.kernels.snapshot(),
            "structs": (self.sinks[shard].drain()
                        if shard in self.sinks else []),
        }
        if extra:
            aux.update(extra)
        return aux

    def handle_plan(self, payload: bytes, dq_s: float) -> list[bytes]:
        sp, flags = decode_plan(payload)
        ex = self.executors[sp.shard]
        payloads, wall = ex.run_plan(sp)
        extra: dict = {"dq_s": dq_s}
        if flags & FLAG_TRACE:
            from ..obs.tracer import Tracer, get_tracer, set_tracer
            tr = get_tracer()
            if not tr.enabled:
                set_tracer(Tracer())
            elif isinstance(tr, Tracer):
                extra["spans"] = tr.drain()
        return encode_reply(sp.shard, sp.seq, wall, payloads,
                            self._aux(sp.shard, extra))

    def handle_flush(self, payload: bytes) -> list[bytes]:
        req = json.loads(payload)
        s = int(req["shard"])
        self.executors[s].flush()
        return [json.dumps(self._aux(s), default=str).encode()]

    def handle_sched(self, payload: bytes) -> list[bytes]:
        req = json.loads(payload)
        s = int(req["shard"])
        self.executors[s].run_scheduler(req.get("reason", "sched"))
        return [json.dumps(self._aux(s), default=str).encode()]

    def handle_stats(self, payload: bytes) -> list[bytes]:
        from ..kernels import native
        req = json.loads(payload)
        s = int(req["shard"])
        full = self.executors[s].stats_full()
        full["aux"] = self._aux(s)
        # This process's kernel launches (all of its shards'), under a
        # key of its own: port-only accounting, in no on-disk format.
        full["launches"] = dict(native.LAUNCHES)
        return [json.dumps(full, default=str).encode()]

    def handle_launches(self, payload: bytes) -> list[bytes]:
        """This process's ``native.LAUNCHES`` (zeroed after the read
        when the request asks for it) and the peak bytes its caching
        allocator held on each of its CUDA devices."""
        import torch
        from ..kernels import native
        cards = sorted({d for d in self.spec.device_ids
                        if d.startswith("cuda")})
        out = {"launches": dict(native.LAUNCHES),
               "peak_allocated": {d: torch.cuda.max_memory_allocated(d)
                                  for d in cards}}
        if json.loads(payload).get("reset"):
            native.reset_launches()
        return [json.dumps(out).encode()]

    def close(self) -> None:
        for ex in self.executors.values():
            ex.close()
        for path in self.locks:
            try:
                os.unlink(path)
            except FileNotFoundError:
                pass


def _worker_main(spec: WorkerSpec, cmd_r, rsp_w, req_name: str,
                 rep_name: str) -> None:
    """Spawn entry point: build the shard slab, handshake READY over the
    pipe (plain JSON — init happens once), then serve ring frames until
    MSG_CLOSE or pipe EOF."""
    import torch
    # One intra-op thread: several workers share the host's cores, and
    # the shard's host work is numpy's anyway.  Changes no result.
    torch.set_num_threads(1)
    req = rep = None
    try:
        req = ShmRing(name=req_name)
        rep = ShmRing(name=rep_name)
        t0 = time.perf_counter()
        host = _WorkerHost(spec)
        ready = {"ok": True, "pid": os.getpid(),
                 "build_s": time.perf_counter() - t0,
                 "shards": {str(s): i for s, i in host.ready_info.items()}}
    except Exception:
        ready = {"ok": False, "error": traceback.format_exc()}
    try:
        rsp_w.send_bytes(json.dumps(ready, default=str).encode())
    except (BrokenPipeError, OSError):
        return
    if not ready["ok"]:
        return

    def reply(mtype: int, seq: int, parts: list[bytes]) -> None:
        off, total = rep.write(mtype, seq, parts)
        rsp_w.send_bytes(TOKEN.pack(mtype, seq, off, total,
                                    time.perf_counter()))

    try:
        while True:
            try:
                tok = cmd_r.recv_bytes()
            except (EOFError, OSError):
                break
            mtype, seq, off, total, t_send = TOKEN.unpack(tok)
            t_recv = time.perf_counter()
            payload = req.read(off, total, mtype, seq)
            req.consume_to(off, total)
            try:
                if mtype == MSG_PLAN:
                    parts = host.handle_plan(payload, t_recv - t_send)
                elif mtype == MSG_FLUSH:
                    parts = host.handle_flush(payload)
                elif mtype == MSG_SCHED:
                    parts = host.handle_sched(payload)
                elif mtype == MSG_STATS:
                    parts = host.handle_stats(payload)
                elif mtype == MSG_LAUNCHES:
                    parts = host.handle_launches(payload)
                elif mtype == MSG_CLOSE:
                    host.close()
                    reply(MSG_CLOSE, seq, [b"{}"])
                    break
                else:
                    raise RuntimeError(f"unknown message type {mtype}")
                reply(mtype, seq, parts)
            except Exception:
                reply(MSG_ERR, seq, [json.dumps(
                    {"error": traceback.format_exc()}).encode()])
    finally:
        if req is not None:
            req.close()
        if rep is not None:
            rep.close()


# --------------------------------------------------------- parent side

class _Slot:
    __slots__ = ("event", "mtype", "data")

    def __init__(self):
        self.event = threading.Event()
        self.mtype = 0
        self.data = None


class ProcWorker:
    """Parent handle for one worker process: rings, pipes, request
    correlation.  ``request`` is thread-safe (many shard threads share
    a worker); replies are matched by seq on the receiver thread."""

    def __init__(self, spec: WorkerSpec, ctx, ring_bytes: int):
        self.spec = spec
        self.req = ShmRing(ring_bytes, create=True)
        self.rep = ShmRing(ring_bytes, create=True)
        self._cmd_r, self._cmd_w = ctx.Pipe(duplex=False)
        self._rsp_r, self._rsp_w = ctx.Pipe(duplex=False)
        self.proc = ctx.Process(
            target=_worker_main,
            args=(spec, self._cmd_r, self._rsp_w,
                  self.req.name, self.rep.name),
            daemon=True, name=f"repro-shard-worker-{spec.worker_id}")
        self._send_lock = threading.Lock()
        self._seq = 0
        self._pending: dict[int, _Slot] = {}
        self._recv_thread = None
        self._dead: str | None = None
        self._closed = False
        self.ready: dict | None = None
        self.bytes_sent = 0
        self.bytes_received = 0
        self.requests = 0

    # Startup ---------------------------------------------------------
    def launch(self) -> None:
        self.proc.start()
        self._cmd_r.close()         # child ends, parent copies
        self._rsp_w.close()

    def wait_ready(self, timeout: float = 180.0) -> dict:
        if not self._rsp_r.poll(timeout):
            self.terminate()
            raise RuntimeError(
                f"shard worker {self.spec.worker_id} did not come up "
                f"within {timeout}s")
        try:
            ready = json.loads(self._rsp_r.recv_bytes())
        except (EOFError, OSError) as e:
            self.terminate()
            raise RuntimeError(
                f"shard worker {self.spec.worker_id} exited during "
                f"startup ({e.__class__.__name__}); spawn re-imports "
                "__main__ — guard script entry points with "
                "if __name__ == '__main__'") from None
        if not ready.get("ok"):
            self.terminate()
            raise RuntimeError(
                f"shard worker {self.spec.worker_id} failed to start:\n"
                f"{ready.get('error')}")
        self.ready = ready
        self._recv_thread = threading.Thread(
            target=self._recv_loop, daemon=True,
            name=f"procpool-recv-{self.spec.worker_id}")
        self._recv_thread.start()
        return ready

    # Receive ---------------------------------------------------------
    def _recv_loop(self) -> None:
        while True:
            try:
                tok = self._rsp_r.recv_bytes()
            except (EOFError, OSError):
                self._fail("worker response pipe closed")
                return
            mtype, seq, off, total, _t = TOKEN.unpack(tok)
            try:
                data = self.rep.read(off, total, mtype, seq)
            except Exception as e:          # corruption: poison everything
                self._fail(str(e))
                return
            self.rep.consume_to(off, total)
            self.bytes_received += total
            slot = self._pending.pop(seq, None)
            if slot is not None:
                slot.mtype = mtype
                slot.data = data
                slot.event.set()
            if mtype == MSG_CLOSE:
                return

    def _fail(self, msg: str) -> None:
        self._dead = msg
        while self._pending:
            _seq, slot = self._pending.popitem()
            slot.event.set()

    # Request ---------------------------------------------------------
    def request(self, mtype: int, parts: list[bytes]) -> bytes:
        if self._dead:
            raise RuntimeError(
                f"shard worker {self.spec.worker_id} is gone: "
                f"{self._dead}")
        slot = _Slot()
        with self._send_lock:
            self._seq += 1
            seq = self._seq
            self._pending[seq] = slot
            off, total = self.req.write(mtype, seq, parts)
            self.bytes_sent += total
            self.requests += 1
            try:
                self._cmd_w.send_bytes(
                    TOKEN.pack(mtype, seq, off, total,
                               time.perf_counter()))
            except (BrokenPipeError, OSError) as e:
                self._pending.pop(seq, None)
                raise RuntimeError(
                    f"shard worker {self.spec.worker_id} died "
                    f"(command pipe): {e}") from None
        while not slot.event.wait(timeout=1.0):
            if self._dead or not self.proc.is_alive():
                self._pending.pop(seq, None)
                raise RuntimeError(
                    f"shard worker {self.spec.worker_id} died: "
                    f"{self._dead or 'process exited'}")
        if slot.data is None:
            raise RuntimeError(
                f"shard worker {self.spec.worker_id} died: "
                f"{self._dead or 'no reply'}")
        if slot.mtype == MSG_ERR:
            err = json.loads(slot.data)
            raise RuntimeError(
                f"shard worker {self.spec.worker_id} error:\n"
                f"{err.get('error')}")
        return slot.data

    # Shutdown --------------------------------------------------------
    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self.proc.is_alive() and not self._dead:
            try:
                self.request(MSG_CLOSE, [b"{}"])
            except RuntimeError:
                pass
        self.proc.join(timeout=10)
        if self.proc.is_alive():
            self.proc.terminate()
            self.proc.join(timeout=5)
        if self._recv_thread is not None:
            self._recv_thread.join(timeout=5)
        for p in (self._cmd_w, self._rsp_r):
            try:
                p.close()
            except OSError:
                pass
        for ring in (self.req, self.rep):
            ring.close()
            ring.unlink()

    def terminate(self) -> None:
        if self.proc.is_alive():
            self.proc.terminate()
            self.proc.join(timeout=5)
        for ring in (self.req, self.rep):
            ring.close()
            ring.unlink()


class ProcShard:
    """Engine-facing proxy for a shard living in a worker process.

    Mirrors the ``ShardExecutor`` surface the engine and collector use
    (``run_plan``, ``flush``, ``run_scheduler``, ``stats_full``, the
    I/O/entries/kernels accessors).  Mirror values refresh from each
    reply's cumulative aux blob — overwrite, never accumulate, so
    repeated ``stats()`` calls are idempotent.  Direct ``.tree`` access
    is impossible by design (the tree lives in another process)."""

    def __init__(self, shard_id: int, worker: ProcWorker,
                 pool: "ProcPool"):
        self.shard_id = int(shard_id)
        self.worker = worker
        self.pool = pool
        self.manifest = None        # parent-side manifest (attach below)
        self.wal = None             # WAL lives in the worker
        self.scheduler = None       # ditto; run_scheduler round-trips
        self._io = (0, 0)
        self._entries = 0
        self._kern: dict = {}

    @property
    def tree(self):
        raise RuntimeError(
            f"shard {self.shard_id} runs in worker process "
            f"{self.worker.spec.worker_id} (EngineConfig.procs); its "
            "LSMTree is not addressable from the parent — use "
            "engine.stats() / stats_full(), or build the engine with "
            "procs=0 for in-process introspection")

    # Mirrors ---------------------------------------------------------
    @property
    def io_reads(self) -> int:
        return self._io[0]

    @property
    def io_writes(self) -> int:
        return self._io[1]

    @property
    def num_entries(self) -> int:
        return self._entries

    @property
    def kernels(self):
        from .stats import KernelCounters
        return KernelCounters.from_snapshot(self._kern)

    def _apply_aux(self, aux: dict) -> None:
        io = aux.get("io")
        if io is not None:
            self._io = (int(io[0]), int(io[1]))
        if "entries" in aux:
            self._entries = int(aux["entries"])
        if "kernels" in aux:
            self._kern = aux["kernels"]
        dq = aux.get("dq_s")
        if dq is not None:
            self.pool.dequeue_hist.record(max(0.0, float(dq)))
        if self.manifest is not None:
            for desc, reason in aux.get("structs") or []:
                self.manifest.record_structure_desc(
                    self.shard_id, desc, reason=reason)
        spans = aux.get("spans")
        if spans:
            from ..obs.tracer import get_tracer
            tr = get_tracer()
            if getattr(tr, "absorb", None):
                tr.absorb(
                    spans, pid=self.worker.proc.pid,
                    process_name=(f"shard-worker-"
                                  f"{self.worker.spec.worker_id}"))

    # Execution -------------------------------------------------------
    def run_plan(self, sp: ShardPlan) -> tuple[list, float]:
        from ..obs.tracer import tracing_enabled
        flags = FLAG_TRACE if tracing_enabled() else 0
        result_steps = [st for st in sp.steps
                        if st.kind in (OP_GET, OP_RANGE_SCAN)]
        data = self.worker.request(
            MSG_PLAN, encode_plan(self.shard_id, sp, flags))
        payloads, wall, aux = decode_reply(data, result_steps)
        self._apply_aux(aux)
        return payloads, wall

    def _control(self, mtype: int, req: dict) -> dict:
        data = self.worker.request(
            mtype, [json.dumps(req).encode()])
        out = json.loads(data)
        self._apply_aux(out.get("aux", out))
        return out

    def flush(self) -> None:
        self._control(MSG_FLUSH, {"shard": self.shard_id})

    def run_scheduler(self, reason: str = "sched") -> None:
        if self.worker._closed or self.worker._dead:
            return
        self._control(MSG_SCHED, {"shard": self.shard_id,
                                  "reason": reason})

    def stats_full(self) -> dict:
        full = self._control(MSG_STATS, {"shard": self.shard_id})
        full.pop("aux", None)
        self.pool.worker_launches[self.worker.spec.worker_id] = \
            full.pop("launches")
        # JSON stringifies the int level keys; normalize back so the
        # engine's aggregation code is mode-blind.
        lsm = full.get("lsm")
        if lsm:
            for k in ("compaction_bytes", "rt_compaction_bytes",
                      "rt_density"):
                if lsm.get(k):
                    lsm[k] = {int(i): v for i, v in lsm[k].items()}
        return full

    def cache_snapshot(self) -> dict:
        return self.stats_full()["cache"]

    def close(self) -> None:      # pool owns worker shutdown
        pass


class ProcPool:
    """The worker fleet: spawns ``procs`` processes (shards assigned
    round-robin, ``shard % procs``), hands out ``ProcShard`` proxies,
    and aggregates transport counters and the workers' kernel
    launches."""

    def __init__(self, *, num_shards: int, procs: int, strategy: str,
                 lsm_config, gloran_config, config, background: bool,
                 device_ids: list, wal_dir: str | None = None,
                 replay: bool = False):
        import multiprocessing as mp
        from ..obs.hist import LatencyHistogram
        from ..obs.tracer import tracing_enabled
        ctx = mp.get_context("spawn")
        self.procs = int(procs)
        self.num_shards = int(num_shards)
        self._closed = False
        ring_bytes = int(config.proc_ring_bytes)
        # Workers run their shards in-process, serially, without their
        # own WAL config (the spec's wal_dir drives stream ownership
        # explicitly) — the parent engine owns routing and pipelining.
        # ``replace`` re-runs the config's device check here; each
        # worker resolves its shards' devices again when it starts.
        worker_cfg = replace(config, procs=0, wal_dir=None, devices=0,
                             scheduler=False, pipeline=False)
        trace = tracing_enabled()
        self.workers: list[ProcWorker] = []
        for w in range(self.procs):
            shard_ids = tuple(s for s in range(self.num_shards)
                              if s % self.procs == w)
            spec = WorkerSpec(
                worker_id=w, shard_ids=shard_ids,
                device_ids=tuple(device_ids[s] for s in shard_ids),
                strategy=strategy,
                lsm_config=lsm_config, gloran_config=gloran_config,
                engine_config=worker_cfg, background=background,
                wal_dir=wal_dir, replay=replay, trace=trace)
            self.workers.append(ProcWorker(spec, ctx, ring_bytes))
        try:
            t0 = time.perf_counter()
            for pw in self.workers:         # spawn concurrently...
                pw.launch()
            t1 = time.perf_counter()
            for pw in self.workers:         # ...then gate on READY
                pw.wait_ready()
        except Exception:
            self.close()
            raise
        # Seconds to start every process, and until every worker had
        # built its shards (and replayed their streams) and said READY.
        self.startup_s = {"spawn": t1 - t0,
                          "ready": time.perf_counter() - t0}
        self.shards = [ProcShard(s, self.workers[s % self.procs], self)
                       for s in range(self.num_shards)]
        self.dequeue_hist = LatencyHistogram()
        # Each worker's ``native.LAUNCHES`` as its last STATS reply
        # carried them (``launches()`` asks afresh), and its allocator's
        # peak bytes a card as the last ``launches()`` read them.
        self.worker_launches: dict[int, dict] = {}
        self.worker_peak_allocated: dict[int, dict] = {}
        self.frames_replayed = 0
        self.recovered_descs: dict[int, dict] = {}
        for pw in self.workers:
            for s, info in (pw.ready or {}).get("shards", {}).items():
                self.shards[int(s)]._apply_aux(info["aux"])
                self.frames_replayed += int(info.get("frames") or 0)
                if info.get("desc"):
                    self.recovered_descs[int(s)] = info["desc"]
        self._closed = False

    def _launches(self, reset: bool) -> list[dict]:
        body = [json.dumps({"reset": reset}).encode()]
        for pw in self.workers:
            rep = json.loads(pw.request(MSG_LAUNCHES, body))
            self.worker_launches[pw.spec.worker_id] = rep["launches"]
            self.worker_peak_allocated[pw.spec.worker_id] = \
                rep["peak_allocated"]
        return [self.worker_launches[pw.spec.worker_id]
                for pw in self.workers]

    def launches(self, per_worker: bool = False):
        """The workers' kernel launches, read from each worker now:
        summed by kernel name, or one dict a worker."""
        rows = self._launches(reset=False)
        if per_worker:
            return rows
        out: dict[str, int] = {}
        for row in rows:
            for name, n in row.items():
                out[name] = out.get(name, 0) + n
        return out

    def reset_launches(self) -> None:
        """Zero every worker's ``native.LAUNCHES``."""
        self._launches(reset=True)

    def transport_snapshot(self) -> dict:
        return {
            "workers": self.procs,
            "requests": sum(w.requests for w in self.workers),
            "bytes_sent": sum(w.bytes_sent for w in self.workers),
            "bytes_received": sum(w.bytes_received for w in self.workers),
            "dequeue_latency_us": self.dequeue_hist.snapshot(),
        }

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for pw in self.workers:
            pw.close()
