"""Durable state crosses between the packages, on the CPU.

The WAL, manifest and snapshot formats are shared byte for byte: the
same op stream writes identical segment files and an equal manifest
config doc in ``repro`` and ``repro_torch``; a directory written by
either package recovers in the other to the store the writing package
recovers itself (all 5 strategies, full replay and snapshot plus WAL
tail).  Also the counterpart of the reference's
``tests/test_scheduler.py::test_wal_recovery_background_matches_inline``
and the snapshot that is ahead of the WAL.
"""

import glob
import os
import shutil
from dataclasses import asdict, fields

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.lsm as jlsm
import repro_torch.core as tcore
import repro_torch.lsm as tlsm
from repro.durable import configs_from_doc as jconfigs_from_doc
from repro.durable import take_snapshot as jtake_snapshot
from repro_torch.durable import (LevelManifest, configs_from_doc,
                                 engine_config_doc, take_snapshot)
from repro_torch.lsm import STRATEGIES
from torch_durable_cells import (apply_workload, assert_same_store,
                                 make_engine, mixed_ops, observe,
                                 recover_in, segment_files)

torch.set_num_threads(1)


def first_manifest(wal_dir) -> dict:
    path = sorted(glob.glob(os.path.join(str(wal_dir), "manifest",
                                         "MANIFEST-*.json")))
    return LevelManifest.load(os.path.dirname(path[0])).doc


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("shards", [1, 3])
def test_same_stream_writes_identical_segments_and_config_doc(
        tmp_path, strategy, shards):
    engines = {}
    for side in (True, False):
        eng = make_engine(side, tmp_path / str(side), shards=shards,
                          strategy=strategy, segment_bytes=1024)
        apply_workload(eng, mixed_ops(seed=5, n_batches=5))
        engines[side] = eng
    docs = {side: engine_config_doc(e) for side, e in engines.items()}
    for eng in engines.values():
        eng.close()
    port, ref = (segment_files(tmp_path / str(s)) for s in (True, False))
    assert len(port) > shards  # rotation happened
    assert port == ref
    assert docs[True] == docs[False]
    assert first_manifest(tmp_path / "True")["config"] == \
        first_manifest(tmp_path / "False")["config"] == docs[True]
    # Each package reads the other's config doc into its own configs,
    # field for field.
    mine = configs_from_doc(docs[False])
    theirs = jconfigs_from_doc(docs[True])
    assert mine[:3] == theirs[:3] == (shards, strategy, "hash")
    assert asdict(mine[3]) == asdict(theirs[3])
    assert (mine[4] is None) == (theirs[4] is None) == \
        (strategy != "gloran")
    if mine[4] is not None:
        assert asdict(mine[4]) == asdict(theirs[4])


@pytest.mark.parametrize("name", ["LSMConfig", "LSMDRTreeConfig",
                                  "RAEConfig", "GloranConfig"])
def test_config_docs_fields_match_reference(name):
    """Recovery rebuilds configs from the other package's doc, so every
    field matches name for name and default for default."""
    lsm = name == "LSMConfig"
    mine = getattr(tlsm if lsm else tcore, name)
    theirs = getattr(jlsm if lsm else jcore, name)
    assert [f.name for f in fields(mine)] == \
        [f.name for f in fields(theirs)]
    assert asdict(mine()) == asdict(theirs())


def write_store(torch_side: bool, wal_dir, strategy: str):
    """A 2-shard store: the stream, a snapshot, then a tail of puts,
    a range delete and point deletes.  Returns the live engine (closed)."""
    eng = make_engine(torch_side, wal_dir, shards=2, strategy=strategy)
    apply_workload(eng, mixed_ops(seed=11))
    (take_snapshot if torch_side else jtake_snapshot)(eng)
    tail = np.arange(30000, 30020, dtype=np.uint64)
    eng.put_batch(tail, tail * np.uint64(5))
    eng.range_delete(30005, 30008)
    eng.delete_batch(tail[-3:])
    eng.close()
    return eng


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("use_snapshot", [False, True],
                         ids=["full_replay", "snapshot_tail"])
@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_recovery_crosses_packages(tmp_path, writer, strategy,
                                   use_snapshot):
    """A directory written by one package recovers in the other to the
    store the writing package recovers itself (and to the live store)."""
    torch_writer = writer == "repro_torch"
    live = write_store(torch_writer, tmp_path / "wal", strategy)
    shutil.copytree(tmp_path / "wal", tmp_path / "copy")
    own = recover_in(torch_writer, tmp_path / "wal",
                     use_snapshot=use_snapshot)
    other = recover_in(not torch_writer, tmp_path / "copy",
                       use_snapshot=use_snapshot)
    assert own.recovery["snapshot_loaded"] == \
        other.recovery["snapshot_loaded"] == int(use_snapshot)
    assert own.recovery["frames_replayed"] == \
        other.recovery["frames_replayed"]
    if use_snapshot:
        # The tail alone: one put, one range delete and one delete
        # frame a shard at most.
        assert other.recovery["frames_replayed"] <= 6
    got = observe(other)
    assert got == observe(own)
    assert got == observe(live)
    # The recovered store keeps appending in the shared format.
    for eng in (own, other):
        eng.put_batch(np.arange(40000, 40010, dtype=np.uint64),
                      np.arange(40000, 40010, dtype=np.uint64))
        eng.close()
    assert segment_files(tmp_path / "wal") == segment_files(tmp_path /
                                                            "copy")


def test_wal_recovery_background_matches_inline(tmp_path):
    """The port's WAL written with the scheduler on recovers to the same
    store as the port's WAL written inline (FLUSH frames ack only after
    the background flush published), and to the reference's recovery of
    its own scheduler-on WAL of the same stream."""
    ops = mixed_ops(seed=23)
    recovered = {}
    for name, side, sched in (("inline", True, False), ("bg", True, True),
                              ("ref_bg", False, True)):
        eng = make_engine(side, tmp_path / name, shards=2,
                          scheduler=sched)
        apply_workload(eng, ops)
        eng.close()
        recovered[name] = recover_in(side, tmp_path / name)
        assert recovered[name].recovery["frames_replayed"] > 0
    assert_same_store(recovered["inline"], recovered["bg"])
    assert_same_store(recovered["bg"], recovered["ref_bg"])
    assert segment_files(tmp_path / "bg") == segment_files(tmp_path /
                                                           "ref_bg")
    for eng in recovered.values():
        eng.close()


def test_pipelined_scheduler_wal_recovers_like_reference(tmp_path):
    """Pipelined shard threads append and fsync concurrently, one
    appender a stream: the port's WAL of a pipelined scheduler-on store
    equals the reference's byte for byte, and both recover alike."""
    ops = mixed_ops(seed=29, n_batches=8)
    recovered = {}
    for side in (True, False):
        d = tmp_path / str(side)
        eng = make_engine(side, d, shards=4, scheduler=True, pipeline=True)
        apply_workload(eng, ops)
        eng.close()
        recovered[side] = recover_in(side, d)
    assert segment_files(tmp_path / "True") == segment_files(tmp_path /
                                                             "False")
    assert_same_store(recovered[True], recovered[False])
    for eng in recovered.values():
        eng.close()


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_snapshot_ignored_when_ahead_of_wal(tmp_path, writer):
    """A snapshot recorded past the durable prefix (possible under
    fsync='never' + power loss) is discarded by both packages; full
    replay of what survived wins."""
    torch_writer = writer == "repro_torch"
    eng = make_engine(torch_writer, tmp_path / "wal", shards=1)
    keys = np.arange(1, 64, dtype=np.uint64)
    eng.put_batch(keys, keys)
    (take_snapshot if torch_writer else jtake_snapshot)(eng)
    eng.close()
    # Simulate the snapshot's WAL foundation vanishing.
    for seg in glob.glob(str(tmp_path / "wal" / "shard-000" / "*.wal")):
        os.remove(seg)
    shutil.copytree(tmp_path / "wal", tmp_path / "copy")
    for side, d in ((True, "wal"), (False, "copy")):
        rec = recover_in(side, tmp_path / d)
        assert rec.recovery["snapshot_loaded"] == 0
        found, _ = rec.get_batch(keys)
        assert not found.any()
        rec.close()
