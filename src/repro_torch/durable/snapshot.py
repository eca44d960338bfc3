"""Full-store snapshots for snapshot + WAL-tail restarts.

A snapshot is an atomic, versioned directory (``snap-<n>/``: one npz per
shard + ``meta.json``) holding everything needed to reconstruct each
shard's LSMTree bit-for-bit: memtable entries, LRR buffers, every
SSTable level's arrays *plus its Bloom seed* (the filter rebuilds
deterministically from keys + seed), range-tombstone blocks, sequence
counters, and — the GLORAN twist — the staging buffer's raw records, the
DR-tree index levels, the index epoch/GC floor, and the full EVE chain
(per-RAE capacity/seed/count/seq-window + filter words), so recovered
stores reproduce exactly the same lookup validity verdicts.

``meta.json`` records the per-shard WAL frame positions at snapshot time
(and the manifest version), so a restart loads the snapshot and replays
only the WAL *tail* — recovery cost proportional to work since the last
snapshot, not store size.  Publication is write-tmp-then-rename
(``durable.atomic``) with keep-last-k GC, same as checkpoints.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..core.areas import AreaSet
from ..lsm.sstable import RangeTombstoneBlock, SSTable
from .atomic import (atomic_publish_dir, clear_stale_tmp, fsync_dir,
                     keep_last_k, list_versions, versioned_name)

PREFIX = "snap-"


def latest_snapshot(directory: str) -> str | None:
    """Path of the newest published snapshot under ``directory``."""
    if not os.path.isdir(directory):
        return None
    versions = list_versions(directory, PREFIX)
    if not versions:
        return None
    return os.path.join(directory, versioned_name(PREFIX, versions[-1]))


def _shard_arrays(tree) -> tuple[dict, dict]:
    """(npz arrays, JSON meta) capturing one shard's tree exactly."""
    arrays: dict = {}
    meta: dict = {
        "seq": int(tree.seq),
        "sstable_seed": int(tree._sstable_seed),
        "strategy": tree.strategy,
        "levels": [],
        "level_rts": len(tree.level_rts),
    }
    if tree.mem:
        rows = np.array([(k, s, t, v)
                         for k, (s, t, v) in tree.mem.items()],
                        dtype=np.uint64)
    else:
        rows = np.zeros((0, 4), dtype=np.uint64)
    arrays["mem"] = rows
    arrays["mem_rts"] = (np.array(tree.mem_rts, dtype=np.uint64)
                         if tree.mem_rts
                         else np.zeros((0, 3), dtype=np.uint64))
    for i, lvl in enumerate(tree.levels):
        if lvl is None:
            meta["levels"].append(None)
            continue
        meta["levels"].append({"seed": int(lvl.seed)})
        arrays[f"lvl{i}_keys"] = lvl.keys
        arrays[f"lvl{i}_seqs"] = lvl.seqs
        arrays[f"lvl{i}_types"] = lvl.types
        arrays[f"lvl{i}_vals"] = lvl.vals
    for i, rtb in enumerate(tree.level_rts):
        arrays[f"rt{i}_starts"] = rtb.starts
        arrays[f"rt{i}_ends"] = rtb.ends
        arrays[f"rt{i}_seqs"] = rtb.seqs
    if tree.gloran is not None:
        g = tree.gloran
        idx = g.index
        if not hasattr(idx, "_make_drtree"):
            raise ValueError(
                "snapshots support the DR-tree GLORAN index only "
                "(GLORAN0's R-tree levels recover via WAL replay)")
        meta["gloran"] = {
            "gc_floor": int(g.gc_floor),
            "num_range_deletes": int(g.num_range_deletes),
            "epoch": int(getattr(idx, "epoch", 0)),
            "records_inserted": int(getattr(idx, "records_inserted", 0)),
            "index_levels": [lvl is not None
                             for lvl in getattr(idx, "levels", [])],
            "eve": None,
        }
        stg = idx.buffer.extract_all()
        arrays["stg_lo"], arrays["stg_hi"] = stg.lo, stg.hi
        arrays["stg_smin"], arrays["stg_smax"] = stg.smin, stg.smax
        for i, lvl in enumerate(getattr(idx, "levels", [])):
            if lvl is None:
                continue
            a = lvl.areas
            arrays[f"gl{i}_lo"], arrays[f"gl{i}_hi"] = a.lo, a.hi
            arrays[f"gl{i}_smin"], arrays[f"gl{i}_smax"] = a.smin, a.smax
        if g.eve is not None:
            # RAE seeds are assigned deterministically by chain position
            # (EVE._next_seed starts at 1 and increments per RAE), so
            # replaying _new_rae with the saved capacities reproduces
            # them; capacity/count/seq-window are captured explicitly.
            metas = []
            for j, rae in enumerate(g.eve.chain):
                arrays[f"eve{j}_words"] = rae.bloom.words
                metas.append({
                    "capacity": int(rae.config.capacity),
                    "count": int(rae.count),
                    "min_seq": rae.min_seq,
                    "max_seq": int(rae.max_seq),
                })
            meta["gloran"]["eve"] = {
                "next_seed": int(g.eve._next_seed),
                "raes": metas,
            }
    return arrays, meta


def save_snapshot(engine, directory: str, *, keep: int = 2) -> str:
    """Publish one atomic snapshot of a drained engine; returns its
    path.  Call via ``take_snapshot`` (which drains and records the
    manifest pointer)."""
    os.makedirs(directory, exist_ok=True)
    versions = list_versions(directory, PREFIX)
    version = (versions[-1] + 1) if versions else 1
    final = os.path.join(directory, versioned_name(PREFIX, version))
    tmp = final + ".tmp"
    clear_stale_tmp(tmp)
    os.makedirs(tmp)
    wal_frames = {
        s: (sh.wal.frames_appended if getattr(sh, "wal", None) else 0)
        for s, sh in enumerate(engine.shards)}
    meta = {
        "version": version,
        "num_shards": engine.num_shards,
        "wal_frames": {str(s): n for s, n in wal_frames.items()},
        "manifest_version": getattr(
            getattr(engine, "manifest", None), "version", None),
        "shards": [],
    }
    for s, sh in enumerate(engine.shards):
        arrays, shard_meta = _shard_arrays(sh.tree)
        np.savez(os.path.join(tmp, f"shard-{s:03d}.npz"), **arrays)
        meta["shards"].append(shard_meta)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    atomic_publish_dir(tmp, final)
    fsync_dir(directory)
    keep_last_k(directory, PREFIX, keep)
    return final


def take_snapshot(engine, directory: str | None = None, *,
                  keep: int = 2) -> str:
    """Drain, publish a snapshot, and point the manifest at it (with the
    per-shard WAL positions it covers) so the next restart replays only
    the tail.  ``directory`` defaults to ``<wal_dir>/snapshots``."""
    if getattr(engine, "procs", 0):
        raise RuntimeError(
            "take_snapshot needs direct tree access, but this engine's "
            "shards live in worker processes (EngineConfig.procs); "
            "procs-mode stores recover by full WAL replay — snapshot "
            "from an in-process (procs=0) engine")
    engine.drain()
    if directory is None:
        if not engine.wal_dir:
            raise ValueError("no wal_dir on this engine; pass an "
                             "explicit snapshot directory")
        directory = os.path.join(engine.wal_dir, "snapshots")
    path = save_snapshot(engine, directory, keep=keep)
    if engine.manifest is not None:
        frames = {
            s: (sh.wal.frames_appended if sh.wal is not None else 0)
            for s, sh in enumerate(engine.shards)}
        engine.manifest.record_snapshot(os.path.basename(path), frames)
    return path


def _restore_tree(tree, arrays, meta: dict) -> None:
    """Load one shard's saved state into a freshly constructed tree."""
    cfg = tree.config
    mem = arrays["mem"]
    tree.mem = {int(k): (int(s), int(t), int(v))
                for k, s, t, v in mem.tolist()}
    tree._mem_snap = None
    tree.mem_rts = [tuple(int(x) for x in row)
                    for row in arrays["mem_rts"].tolist()]
    tree._mem_rt_blk = None
    tree.seq = int(meta["seq"])
    tree._sstable_seed = int(meta["sstable_seed"])
    tree.levels = []
    for i, lm in enumerate(meta["levels"]):
        if lm is None:
            tree.levels.append(None)
            continue
        tree.levels.append(SSTable(
            arrays[f"lvl{i}_keys"], arrays[f"lvl{i}_seqs"],
            arrays[f"lvl{i}_types"], arrays[f"lvl{i}_vals"], cfg,
            seed=int(lm["seed"])))
    tree.level_rts = [
        RangeTombstoneBlock(arrays[f"rt{i}_starts"],
                            arrays[f"rt{i}_ends"],
                            arrays[f"rt{i}_seqs"], cfg)
        for i in range(int(meta["level_rts"]))]
    gm = meta.get("gloran")
    if gm is None or tree.gloran is None:
        return
    g = tree.gloran
    idx = g.index
    g.gc_floor = int(gm["gc_floor"])
    g.num_range_deletes = int(gm["num_range_deletes"])
    idx.buffer.clear()
    if len(arrays["stg_lo"]):
        idx.buffer.insert_batch(arrays["stg_lo"], arrays["stg_hi"],
                                arrays["stg_smin"], arrays["stg_smax"])
    idx.levels = []
    for i, present in enumerate(gm["index_levels"]):
        if not present:
            idx.levels.append(None)
            continue
        areas = AreaSet(arrays[f"gl{i}_lo"], arrays[f"gl{i}_hi"],
                        arrays[f"gl{i}_smin"], arrays[f"gl{i}_smax"])
        idx.levels.append(idx._make_drtree(areas))
    idx.epoch = int(gm["epoch"])
    idx.records_inserted = int(gm["records_inserted"])
    em = gm.get("eve")
    if em is not None and g.eve is not None:
        eve = g.eve
        eve._next_seed = 1
        chain = []
        for j, rm in enumerate(em["raes"]):
            rae = eve._new_rae(int(rm["capacity"]))
            rae.bloom.words = arrays[f"eve{j}_words"].astype(
                np.uint32, copy=True)
            rae.count = int(rm["count"])
            rae.min_seq = rm["min_seq"]
            rae.max_seq = int(rm["max_seq"])
            chain.append(rae)
        eve.chain = chain
        eve._next_seed = int(em["next_seed"])


def load_snapshot(engine, path: str) -> dict:
    """Restore a published snapshot into a freshly built engine (same
    topology/configs).  Returns the per-shard WAL frame positions the
    snapshot covers — recovery replays only frames past them."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    assert meta["num_shards"] == engine.num_shards, \
        f"snapshot has {meta['num_shards']} shards, engine has " \
        f"{engine.num_shards}"
    for s, sh in enumerate(engine.shards):
        with np.load(os.path.join(path, f"shard-{s:03d}.npz")) as data:
            arrays = {k: data[k] for k in data.files}
        _restore_tree(sh.tree, arrays, meta["shards"][s])
    return {int(s): int(n) for s, n in meta["wal_frames"].items()}
