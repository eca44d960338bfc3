"""Durability: columnar WAL, level manifest, snapshots, crash-consistent
recovery — host code, the same on the card and on the CPU.

Turn it on by pointing ``EngineConfig.wal_dir`` at a directory; reopen
the directory after a crash (or clean ``close()``) with ``recover``::

    cfg = EngineConfig(wal_dir="/data/store", fsync="batch")
    with Engine(4, config=cfg) as eng:
        eng.put_batch(keys, vals)          # acked only after WAL append
    eng = recover("/data/store")           # byte-identical store

The on-disk formats are the JAX package's, byte for byte: segments,
manifest documents and snapshots written by either package recover in
the other.  ``docs/DURABILITY.md`` describes the frame format, the fsync
policies and the recovery sequence.
"""

from .atomic import (atomic_publish_dir, atomic_write_bytes,
                     atomic_write_json, clear_stale_tmp, fsync_dir,
                     keep_last_k, list_versions, versioned_name)
from .manifest import (LevelManifest, configs_from_doc, describe_tree,
                       engine_config_doc, structure_fingerprint)
from .recovery import recover, replay_frame
from .snapshot import (latest_snapshot, load_snapshot, save_snapshot,
                       take_snapshot)
from .wal import (FRAME_BATCH, FRAME_FLUSH, FSYNC_POLICIES, WalFrame,
                  WalReader, WalWriter, decode_payload, encode_frame,
                  wal_has_frames, wal_shards)

__all__ = [
    "atomic_publish_dir", "atomic_write_bytes", "atomic_write_json",
    "clear_stale_tmp", "fsync_dir", "keep_last_k", "list_versions",
    "versioned_name",
    "LevelManifest", "configs_from_doc", "describe_tree",
    "engine_config_doc", "structure_fingerprint",
    "recover", "replay_frame",
    "latest_snapshot", "load_snapshot", "save_snapshot", "take_snapshot",
    "FRAME_BATCH", "FRAME_FLUSH", "FSYNC_POLICIES", "WalFrame",
    "WalReader", "WalWriter", "decode_payload", "encode_frame",
    "wal_has_frames", "wal_shards",
]
