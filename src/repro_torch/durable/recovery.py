"""Cold-start recovery: manifest -> (snapshot) -> WAL-tail replay.

``recover(wal_dir)`` rebuilds a live engine from the durable directory
alone:

1. **Manifest** — load the newest committed ``MANIFEST-<v>.json``; its
   config doc carries topology + strategy + storage configs, so the
   caller needs nothing but the path.
2. **WAL scan** — read every shard stream's durable prefix
   (torn-tail-tolerant) and truncate the garbage past it, so the
   re-opened writers append exactly after the last acknowledged frame.
3. **Snapshot fast path** — if the manifest points at a published
   snapshot whose recorded WAL positions are covered by the durable
   prefix, load it and replay only the *tail*; otherwise replay the
   whole log from an empty store.  With ``EngineConfig.procs`` set, the
   worker processes replay their own streams in parallel, from the
   whole log, and the parent records their level records.
4. **Replay** — frames re-enter through the shard executors' own write
   paths (``put_batch`` / ``delete_batch`` / ``range_delete_arrays``,
   FLUSH markers through ``LSMTree.flush``).  Because every batch-insert
   path chunks at its flush/capacity boundaries (memtable,
   ``StagingBuffer.insert_batch`` via ``LSMDRTree.insert_batch``, the
   EVE chain) and sequence numbers are re-issued by the same
   ``_next_seqs`` arithmetic, the rebuilt store's flush points, level
   shapes, and lookup verdicts are byte-identical to the pre-crash
   store's durable prefix.  Replay's compactions order their merges
   through the shards' merge-rank kernel hook, as live ones do.  The
   ``DeviceFilterRegistry`` is NOT warmed here — rebuilt SSTables/epochs
   carry fresh uids, so the registry re-packs lazily on the first lookup
   batch, exactly like any post-compaction invalidation.
5. **Re-attach** — WAL writers resume at the durable tail, the loaded
   manifest is re-wired, and per-shard "recover" edits are committed.

Recovery timings land in ``engine.recovery`` and surface through
``engine.stats()["metrics"]`` as ``recovery.wall_s`` /
``recovery.frames_replayed`` / ``recovery.snapshot_loaded``.
"""

from __future__ import annotations

import os
import time

import numpy as np

from .manifest import LevelManifest, configs_from_doc
from .snapshot import load_snapshot
from .wal import FRAME_FLUSH, WalReader, WalWriter

# OP codes are frozen by the WAL format; resolve them through the plan
# module (submodule import — safe against the engine<->durable cycle).
from ..engine.plan import OP_DELETE, OP_PUT, OP_RANGE_DELETE


def replay_frame(sh, frame) -> None:
    """Re-execute one durable frame on a shard executor.

    A frame concatenates the plan's write steps in request order; the
    maximal same-kind runs here may merge steps that were split only by
    interleaved reads, which is equivalence-preserving: every batch
    write path chunks at its own flush/capacity boundaries, so the same
    records cross the same thresholds in the same order.

    Each frame was one shard plan, and with the background scheduler on
    every plan drained due jobs before its steps — replay mirrors that
    drain point so flushes/compactions interleave with the write stream
    at the same boundaries (delete application during bottom compaction
    is order-sensitive).
    """
    sh.run_scheduler("recover")
    if frame.ftype == FRAME_FLUSH:
        sh.flush()
        return
    kinds = frame.kinds
    if not len(kinds):
        return
    cuts = (np.flatnonzero(np.diff(kinds)) + 1).tolist()
    bounds = [0, *cuts, len(kinds)]
    for a, b in zip(bounds[:-1], bounds[1:]):
        k = int(kinds[a])
        if k == OP_PUT:
            sh.put_batch(frame.keys[a:b], frame.vals[a:b])
        elif k == OP_DELETE:
            sh.delete_batch(frame.keys[a:b])
        elif k == OP_RANGE_DELETE:
            sh.range_delete_arrays(frame.los[a:b], frame.his[a:b])


def recover(wal_dir: str, *, config=None, use_snapshot: bool = True):
    """Rebuild a live, durable engine from ``wal_dir``; see module doc.

    ``config`` optionally carries execution knobs (device, kernel gates,
    cache, pipeline, scheduler, fsync policy for the re-opened writers);
    topology and storage configs always come from the manifest.  Returns
    the engine with WAL + manifest re-attached and ``engine.recovery``
    populated.
    """
    from dataclasses import replace

    from ..engine.engine import Engine, _resolve_procs
    from ..engine.executor import EngineConfig

    t0 = time.perf_counter()
    mdir = os.path.join(wal_dir, "manifest")
    manifest = LevelManifest.load(mdir)
    doc = manifest.config
    if not doc:
        raise RuntimeError(f"no committed manifest under {mdir}; "
                           "nothing to recover")
    num_shards, strategy, partition, lsm, gloran = configs_from_doc(doc)
    # wal_dir=None: replay must not re-log, and __init__ must not refuse
    # the non-empty directory; writers re-attach after replay.  The
    # default config's device is the card (no CPU fallback).
    cfg = replace(config or EngineConfig(), partition=partition,
                  wal_dir=None)

    # Procs mode: each worker replays its own shard streams during
    # startup (WAL ownership lives with the worker), the parent loads
    # the manifest and records the shipped-back "recover" level
    # records.  No snapshot fast path — worker trees rebuild from the
    # full log (take_snapshot is refused on procs engines anyway).
    if _resolve_procs(cfg, num_shards):
        engine = Engine(num_shards, strategy=strategy, lsm_config=lsm,
                        gloran_config=gloran, config=cfg,
                        _recover_from=wal_dir)
        engine.recovery["wall_s"] = time.perf_counter() - t0
        return engine

    def fresh() -> "Engine":
        return Engine(num_shards, strategy=strategy, lsm_config=lsm,
                      gloran_config=gloran, config=cfg)

    engine = fresh()
    frames = {}
    for s in range(num_shards):
        r = WalReader(wal_dir, s)
        frames[s] = r.read_frames()
        r.truncate_torn_tail()

    starts = {s: 0 for s in range(num_shards)}
    snap_used = 0
    snap = manifest.snapshot if use_snapshot else None
    if snap is not None:
        path = os.path.join(wal_dir, "snapshots", snap["name"])
        if os.path.isdir(path):
            pos = load_snapshot(engine, path)
            if all(pos.get(s, 0) <= len(frames[s])
                   for s in range(num_shards)):
                starts = {s: pos.get(s, 0) for s in range(num_shards)}
                snap_used = 1
            else:
                # The snapshot saw frames past the durable prefix (a
                # weaker-than-"batch" fsync policy lost the tail it was
                # built on): discard it and replay the full log.
                engine = fresh()

    replayed = 0
    for s in range(num_shards):
        sh = engine.shards[s]
        for fr in frames[s][starts[s]:]:
            replay_frame(sh, fr)
            replayed += 1
    # Background mode: replay enters through the executors' write paths
    # directly (no plans run), so seals queued by capacity boundaries
    # drain here — the manifest records below must describe the fully
    # published level structure, same as a drained live engine.
    engine.drain()

    writers = []
    for s in range(num_shards):
        w = WalWriter(wal_dir, s, segment_bytes=cfg.wal_segment_bytes,
                      fsync=cfg.fsync)
        # Position the appender's counters at the stream totals so
        # later snapshot pointers (frame counts) and the ``wal.bytes``
        # metric stay consistent with the durable log.
        w.frames_appended = len(frames[s])
        sdir = os.path.join(wal_dir, f"shard-{s:03d}")
        if os.path.isdir(sdir):
            w.bytes_written = sum(
                os.path.getsize(os.path.join(sdir, f))
                for f in os.listdir(sdir) if f.endswith(".wal"))
        writers.append(w)
    engine._attach_durability(wal_dir, manifest=manifest,
                              writers=writers)
    for s in range(num_shards):
        manifest.record_structure(s, engine.shards[s].tree,
                                  reason="recover")
    engine.recovery = {
        "wall_s": time.perf_counter() - t0,
        "frames_replayed": replayed,
        "snapshot_loaded": snap_used,
    }
    return engine
