"""Append-only level manifest with atomic versioned commits.

The manifest is the durable record of *structure*: per shard, the level
stack (SSTable uids, key ranges, seq windows, entry counts) and the
GLORAN index epoch; plus the engine topology and serialized configs so
cold-start recovery can rebuild an identical engine from the directory
alone; plus the latest snapshot pointer (which snapshot, and how many
WAL frames per shard it already covers) so restart replays only the
WAL tail.

Commits follow the write-tmp-then-rename discipline (``durable.atomic``):
each commit publishes a complete
``MANIFEST-<version>.json``; readers load the highest parsable version
and fall back to the previous one if the newest is damaged, so there is
never a window in which no consistent manifest exists.  An in-memory
append-only edit log (flush/compaction/GC/recover events) rides along in
each version for observability and post-crash forensics.

fsync policy: only two commits are durability-critical — the initial
one carrying the config doc (recovery cannot rebuild the engine without
it) and snapshot pointers (``record_snapshot`` forces fsync) — and the
engine fsyncs those explicitly.  Routine per-flush/compaction structure
records are NOT load-bearing for crash consistency (recovery replays
the WAL; level records are observability), so they default to the
cheap non-fsynced atomic rename — that is what keeps group-commit WAL
overhead inside the 1.25x acceptance gate.

Thread safety: pipelined shard threads record structure changes
concurrently; a single lock serializes mutation + commit.
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import asdict

from .atomic import atomic_write_json, keep_last_k, list_versions

PREFIX = "MANIFEST-"
SUFFIX = ".json"
MAX_EDITS = 256  # append-only edit log rides in each version, bounded


def _manifest_path(directory: str, version: int) -> str:
    return os.path.join(directory, f"{PREFIX}{version:08d}{SUFFIX}")


def describe_tree(tree) -> dict:
    """The manifest's view of one shard's LSMTree structure."""
    levels = []
    for lvl in tree.levels:
        if lvl is None or len(lvl) == 0:
            levels.append(None)
        else:
            levels.append({
                "uid": int(lvl.uid),
                "n": len(lvl),
                "min_key": int(lvl.keys[0]),
                "max_key": int(lvl.max_key),
                "min_seq": int(lvl.min_seq),
                "max_seq": int(lvl.max_seq),
            })
    out = {
        "levels": levels,
        "seq": int(tree.seq),
        "sstable_seed": int(tree._sstable_seed),
    }
    if tree.gloran is not None:
        out["gloran_epoch"] = tree.gloran.index_epoch
        out["gloran_gc_floor"] = int(tree.gloran.gc_floor)
    return out


def structure_fingerprint(tree) -> tuple:
    """Cheap token that moves iff the durable structure moved: level
    uids (flush/compaction build new SSTables) + the GLORAN index epoch
    (staging flush / index compaction / GC)."""
    uids = tuple(lvl.uid if lvl is not None and len(lvl) else 0
                 for lvl in tree.levels)
    epoch = tree.gloran.index_epoch if tree.gloran is not None else None
    return (uids, epoch)


class LevelManifest:
    """Versioned, atomically-committed manifest for one engine."""

    def __init__(self, directory: str, *, keep: int = 3,
                 config: dict | None = None, fsync: bool = True):
        self.dir = directory
        self.keep = int(keep)
        self.fsync = fsync
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()
        self.version = 0
        self.doc: dict = {
            "version": 0,
            "config": config or {},
            "shards": {},
            "snapshot": None,
            "edits": [],
        }

    # ------------------------------------------------------------ commit
    def _commit_locked(self, fsync: bool | None = None) -> None:
        self.version += 1
        self.doc["version"] = self.version
        if len(self.doc["edits"]) > MAX_EDITS:
            self.doc["edits"] = self.doc["edits"][-MAX_EDITS:]
        atomic_write_json(
            _manifest_path(self.dir, self.version), self.doc,
            fsync=self.fsync if fsync is None else fsync)
        keep_last_k(self.dir, PREFIX, self.keep, SUFFIX)

    def commit(self, *, fsync: bool | None = None) -> int:
        with self._lock:
            self._commit_locked(fsync=fsync)
            return self.version

    # ------------------------------------------------------------- edits
    def record_structure(self, shard: int, tree, *, reason: str) -> int:
        """One structural edit (flush / compaction / GC / recover):
        replace the shard's level record and commit a new version."""
        return self.record_structure_desc(shard, describe_tree(tree),
                                          reason=reason)

    def record_structure_desc(self, shard: int, desc: dict, *,
                              reason: str) -> int:
        """Commit a pre-described level record (``describe_tree``'s
        document, made wherever the tree lives)."""
        with self._lock:
            self.doc["shards"][str(shard)] = desc
            self.doc["edits"].append({
                "shard": int(shard),
                "reason": reason,
                "seq": desc["seq"],
                "gloran_epoch": desc.get("gloran_epoch"),
            })
            self._commit_locked()
            return self.version

    def record_snapshot(self, name: str, wal_frames: dict) -> int:
        """Point the manifest at a published snapshot.  ``wal_frames``
        maps shard id -> frames already folded into the snapshot, so
        recovery replays only frames past those positions."""
        with self._lock:
            self.doc["snapshot"] = {
                "name": name,
                "wal_frames": {str(s): int(n)
                               for s, n in wal_frames.items()},
                "manifest_version": self.version + 1,
            }
            self.doc["edits"].append({"reason": "snapshot", "name": name})
            # The pointer is what makes WAL-tail restarts possible —
            # worth an fsync regardless of the routine-commit policy.
            self._commit_locked(fsync=True)
            return self.version

    # -------------------------------------------------------------- load
    @classmethod
    def load(cls, directory: str, *, keep: int = 3,
             fsync: bool = True) -> "LevelManifest":
        """Load the newest parsable version (fall back past a damaged
        newest file — the atomic rename makes that near-impossible, but
        recovery must not wedge on a scribbled disk)."""
        m = cls(directory, keep=keep, fsync=fsync)
        for v in reversed(list_versions(directory, PREFIX, SUFFIX)):
            try:
                with open(_manifest_path(directory, v)) as f:
                    doc = json.load(f)
            except (OSError, json.JSONDecodeError):
                continue
            m.version = v
            m.doc = doc
            break
        return m

    @property
    def config(self) -> dict:
        return self.doc.get("config", {})

    @property
    def snapshot(self) -> dict | None:
        return self.doc.get("snapshot")

    def shard_record(self, shard: int) -> dict | None:
        return self.doc.get("shards", {}).get(str(shard))


def engine_config_doc(engine) -> dict:
    """Serialize everything recovery needs to rebuild the engine: the
    topology, the strategy, and the storage configs (flat dataclasses —
    JSON round-trips them losslessly)."""
    doc = {
        "num_shards": engine.num_shards,
        "strategy": engine.strategy,
        "partition": engine.router.partition,
        "lsm_config": asdict(engine.lsm_config),
        "gloran_config": None,
    }
    gc = engine._gloran_eff
    if gc is not None:
        doc["gloran_config"] = {
            "index": asdict(gc.index),
            "eve": asdict(gc.eve) if gc.eve is not None else None,
            "use_eve": gc.use_eve,
            "use_drtree": gc.use_drtree,
        }
    return doc


def configs_from_doc(doc: dict):
    """Inverse of ``engine_config_doc``: (num_shards, strategy,
    partition, LSMConfig, GloranConfig | None)."""
    from ..core.gloran import GloranConfig
    from ..core.lsm_drtree import LSMDRTreeConfig
    from ..core.eve import RAEConfig
    from ..lsm.format import LSMConfig

    lsm = LSMConfig(**doc["lsm_config"])
    gloran = None
    g = doc.get("gloran_config")
    if g is not None:
        gloran = GloranConfig(
            index=LSMDRTreeConfig(**g["index"]),
            eve=RAEConfig(**g["eve"]) if g["eve"] is not None else None,
            use_eve=g["use_eve"],
            use_drtree=g["use_drtree"])
    return (int(doc["num_shards"]), doc["strategy"], doc["partition"],
            lsm, gloran)
