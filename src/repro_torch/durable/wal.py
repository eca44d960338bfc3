"""Segmented write-ahead log of columnar op batches (one stream/shard).

The record format IS the engine's typed columnar ``OpBatch``: a frame
carries the write ops of one shard plan as five flat arrays (kinds u8,
keys/vals/los/his u64) — no per-op encoding, one ``tobytes`` per column.
Frames are length-prefixed and CRC-checksummed::

    segment  = SEG_MAGIC(8) | shard u32 | seg_index u32 | frame*
    frame    = payload_len u32 | crc32(payload) u32 | payload
    payload  = ftype u8 | plan_seq u64 | n u32
             | kinds (n)  | keys (8n) | vals (8n) | los (8n) | his (8n)

``ftype`` distinguishes batch frames (``FRAME_BATCH``, replayed through
the shard's write paths) from flush markers (``FRAME_FLUSH``: an explicit
``Engine.flush`` mutated level structure outside any plan, so replay must
flush at the same point to keep level shapes byte-identical).

**Group commit**: the engine appends ONE frame per shard plan — all of a
submitted batch's write steps for that shard — so a single fsync covers
the whole batch.  Appends happen on the shard's single pipeline thread
(the existing per-shard FIFO), which is the writer's thread-safety model:
one appender per stream, no lock.

**Torn tails**: a crash can leave a half-written frame at the end of the
last segment.  ``WalReader`` stops at the first short or CRC-failing
frame and reports the valid byte offset, so recovery replays exactly the
durable prefix and truncates the garbage before appending resumes.

fsync policy (``EngineConfig.fsync``):

  ``batch``   fsync after every appended frame — an acknowledged batch
              survives power loss (the durability default),
  ``rotate``  fsync only on segment rotation and close — bounded loss,
  ``never``   no fsync (OS-buffered only; ``flush()`` still runs so
              bytes survive process death, just not power loss).
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

SEG_MAGIC = b"RWAL0001"
SEG_HEADER = struct.Struct("<8sII")  # magic, shard, segment index
FRAME_HEADER = struct.Struct("<II")  # payload length, crc32(payload)
PAYLOAD_HEADER = struct.Struct("<BQI")  # ftype, plan seq, n ops

FRAME_BATCH = 0
FRAME_FLUSH = 1

FSYNC_POLICIES = ("batch", "rotate", "never")


def shard_dir(wal_dir: str, shard: int) -> str:
    return os.path.join(wal_dir, f"shard-{shard:03d}")


def _seg_path(sdir: str, index: int) -> str:
    return os.path.join(sdir, f"seg-{index:08d}.wal")


def _list_segments(sdir: str) -> list[int]:
    if not os.path.isdir(sdir):
        return []
    out = []
    for name in os.listdir(sdir):
        if name.startswith("seg-") and name.endswith(".wal"):
            try:
                out.append(int(name[4:-4]))
            except ValueError:
                pass
    return sorted(out)


def encode_frame(ftype: int, plan_seq: int, kinds: np.ndarray,
                 keys: np.ndarray, vals: np.ndarray, los: np.ndarray,
                 his: np.ndarray) -> bytes:
    """One checksummed length-prefixed frame around a columnar payload."""
    n = len(kinds)
    payload = b"".join((
        PAYLOAD_HEADER.pack(ftype, plan_seq, n),
        np.ascontiguousarray(kinds, dtype=np.uint8).tobytes(),
        np.ascontiguousarray(keys, dtype=np.uint64).tobytes(),
        np.ascontiguousarray(vals, dtype=np.uint64).tobytes(),
        np.ascontiguousarray(los, dtype=np.uint64).tobytes(),
        np.ascontiguousarray(his, dtype=np.uint64).tobytes(),
    ))
    return FRAME_HEADER.pack(len(payload), zlib.crc32(payload)) + payload


def decode_payload(payload: bytes):
    """payload -> (ftype, plan_seq, kinds, keys, vals, los, his)."""
    ftype, plan_seq, n = PAYLOAD_HEADER.unpack_from(payload, 0)
    at = PAYLOAD_HEADER.size
    kinds = np.frombuffer(payload, np.uint8, n, at)
    at += n
    cols = []
    for _ in range(4):
        cols.append(np.frombuffer(payload, np.uint64, n, at))
        at += 8 * n
    return (ftype, plan_seq, kinds) + tuple(cols)


class WalFrame:
    """One decoded WAL record (a write-only columnar op batch)."""

    __slots__ = ("ftype", "plan_seq", "kinds", "keys", "vals", "los",
                 "his")

    def __init__(self, ftype, plan_seq, kinds, keys, vals, los, his):
        self.ftype = ftype
        self.plan_seq = plan_seq
        self.kinds = kinds
        self.keys = keys
        self.vals = vals
        self.los = los
        self.his = his

    def __len__(self) -> int:
        return len(self.kinds)


class WalWriter:
    """Appender for one shard's log stream (single-threaded by design:
    the shard's pipeline thread IS the only appender, per-shard FIFO)."""

    def __init__(self, wal_dir: str, shard: int, *,
                 segment_bytes: int = 4 << 20, fsync: str = "batch"):
        assert fsync in FSYNC_POLICIES, fsync
        self.dir = shard_dir(wal_dir, shard)
        self.shard = shard
        self.segment_bytes = int(segment_bytes)
        self.fsync_policy = fsync
        os.makedirs(self.dir, exist_ok=True)
        # Durability counters (the engine absorbs these into metrics).
        self.bytes_written = 0
        self.appends = 0
        self.fsyncs = 0
        self.frames_appended = 0
        self.segments_rotated = 0
        segs = _list_segments(self.dir)
        self._seg_index = segs[-1] if segs else 0
        self._file = None
        self._closed = False

    # ---------------------------------------------------------- segments
    def _open_segment(self, index: int, append: bool) -> None:
        path = _seg_path(self.dir, index)
        if append and os.path.exists(path):
            self._file = open(path, "ab")
        else:
            self._file = open(path, "wb")
            hdr = SEG_HEADER.pack(SEG_MAGIC, self.shard, index)
            self._file.write(hdr)
            self.bytes_written += len(hdr)
        self._seg_index = index

    def _ensure_open(self) -> None:
        if self._file is None:
            # Resume at the existing tail (recovery truncated any torn
            # frame before handing the stream back to a writer).
            self._open_segment(self._seg_index,
                               append=bool(_list_segments(self.dir)))

    def _rotate(self) -> None:
        if self.fsync_policy in ("batch", "rotate"):
            self._file.flush()
            os.fsync(self._file.fileno())
            self.fsyncs += 1
        self._file.close()
        self._open_segment(self._seg_index + 1, append=False)
        self.segments_rotated += 1

    # ------------------------------------------------------------ append
    def append(self, ftype: int, plan_seq: int, kinds, keys, vals, los,
               his) -> int:
        """Append one frame; returns bytes written.  With the ``batch``
        policy the frame is durable (fsynced) before this returns — the
        engine acknowledges the batch only after that."""
        assert not self._closed, "append on closed WAL"
        self._ensure_open()
        frame = encode_frame(ftype, plan_seq, kinds, keys, vals, los, his)
        self._file.write(frame)
        # Always reach the OS: process death (vs power loss) never loses
        # an acknowledged frame regardless of fsync policy.
        self._file.flush()
        if self.fsync_policy == "batch":
            os.fsync(self._file.fileno())
            self.fsyncs += 1
        self.bytes_written += len(frame)
        self.appends += 1
        self.frames_appended += 1
        if self._file.tell() >= self.segment_bytes:
            self._rotate()
        return len(frame)

    def append_batch(self, plan_seq: int, kinds, keys, vals, los,
                     his) -> int:
        return self.append(FRAME_BATCH, plan_seq, kinds, keys, vals, los,
                           his)

    def append_flush(self) -> int:
        z8 = np.zeros(0, np.uint8)
        z64 = np.zeros(0, np.uint64)
        return self.append(FRAME_FLUSH, 0, z8, z64, z64, z64, z64)

    # ------------------------------------------------------------- close
    def sync(self) -> None:
        """Flush + fsync whatever has been appended so far."""
        if self._file is not None:
            self._file.flush()
            if self.fsync_policy != "never":
                os.fsync(self._file.fileno())
                self.fsyncs += 1

    def close(self) -> None:
        """Deterministic shutdown: flush, fsync, close (idempotent)."""
        if self._closed:
            return
        self.sync()
        if self._file is not None:
            self._file.close()
            self._file = None
        self._closed = True

    def counters(self) -> dict:
        return {
            "bytes": self.bytes_written,
            "appends": self.appends,
            "fsyncs": self.fsyncs,
            "frames": self.frames_appended,
            "segments": self.segments_rotated + 1,
        }


class WalReader:
    """Torn-tail-tolerant scan of one shard's log stream."""

    def __init__(self, wal_dir: str, shard: int):
        self.dir = shard_dir(wal_dir, shard)
        self.shard = shard
        # Set by read_frames: where the durable prefix ends.
        self.valid_segment: int | None = None
        self.valid_offset: int = 0
        self.torn = False

    def read_frames(self) -> list[WalFrame]:
        """Every decodable frame, in append order, across all segments.

        Stops at the first torn frame (short read, bad CRC, or bad
        segment header) and records ``valid_segment``/``valid_offset`` —
        the truncation point recovery applies before re-opening the
        stream for appends.  Segments after a torn one are ignored (a
        crash mid-rotation leaves garbage only at the tail).
        """
        frames: list[WalFrame] = []
        self.valid_segment, self.valid_offset, self.torn = None, 0, False
        for seg in _list_segments(self.dir):
            path = _seg_path(self.dir, seg)
            with open(path, "rb") as f:
                data = f.read()
            if len(data) < SEG_HEADER.size:
                self.torn = True
                break
            magic, shard, idx = SEG_HEADER.unpack_from(data, 0)
            if magic != SEG_MAGIC or shard != self.shard or idx != seg:
                self.torn = True
                break
            self.valid_segment, self.valid_offset = seg, SEG_HEADER.size
            at = SEG_HEADER.size
            ok = True
            while at + FRAME_HEADER.size <= len(data):
                plen, crc = FRAME_HEADER.unpack_from(data, at)
                body0 = at + FRAME_HEADER.size
                if body0 + plen > len(data):
                    ok = False
                    break
                payload = data[body0:body0 + plen]
                if zlib.crc32(payload) != crc:
                    ok = False
                    break
                frames.append(WalFrame(*decode_payload(payload)))
                at = body0 + plen
                self.valid_offset = at
            if at != len(data) or not ok:
                self.torn = True
                break
        return frames

    def truncate_torn_tail(self) -> None:
        """Cut the last segment back to its durable prefix and drop any
        segments past it, so a re-opened writer appends after the last
        valid frame (call ``read_frames`` first)."""
        if self.valid_segment is None:
            # Nothing durable at all: clear every segment file.
            for seg in _list_segments(self.dir):
                os.remove(_seg_path(self.dir, seg))
            return
        for seg in _list_segments(self.dir):
            if seg > self.valid_segment:
                os.remove(_seg_path(self.dir, seg))
        path = _seg_path(self.dir, self.valid_segment)
        if os.path.getsize(path) > self.valid_offset:
            with open(path, "r+b") as f:
                f.truncate(self.valid_offset)


def wal_shards(wal_dir: str) -> list[int]:
    """Shard ids with a log stream under ``wal_dir``."""
    if not os.path.isdir(wal_dir):
        return []
    out = []
    for name in os.listdir(wal_dir):
        if name.startswith("shard-"):
            try:
                out.append(int(name.split("-")[1]))
            except (IndexError, ValueError):
                pass
    return sorted(out)


def wal_has_frames(wal_dir: str) -> bool:
    """Does any shard stream hold at least one durable frame?  (The
    engine refuses to open such a directory for fresh writes — recovery
    must run first so acknowledged data is never silently orphaned.)"""
    for s in wal_shards(wal_dir):
        if WalReader(wal_dir, s).read_frames():
            return True
    return False
