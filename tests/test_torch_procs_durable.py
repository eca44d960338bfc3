"""Worker processes with a write-ahead log in ``repro_torch``: stream
locks, closing mid-stream, recovery after a procs run in both modes,
the refused snapshot, and procs-mode directories crossing between the
two packages both ways, on the CPU."""

import os

import numpy as np
import pytest
import torch

from repro.durable import recover as jrecover
from repro_torch.durable import recover, take_snapshot
from repro_torch.engine import Engine, OpBatch
from torch_procs_cells import (UNIVERSE, assert_same_results, configs,
                               drive, exec_config, make_engine, reference)

torch.set_num_threads(1)


def test_wal_dir_collision_fails_fast(tmp_path):
    a = make_engine(procs=2, shards=2, wal_dir=str(tmp_path),
                    fsync="never")
    try:
        lsm, gl = configs(True)
        with pytest.raises(RuntimeError,
                           match="owned by live process|failed to start"):
            Engine(2, strategy="gloran", lsm_config=lsm, gloran_config=gl,
                   config=exec_config(True, procs=2,
                                      wal_dir=str(tmp_path),
                                      fsync="never"))
    finally:
        a.close()
    # Locks release on clean close.
    assert not [f for _, _, fs in os.walk(tmp_path) for f in fs
                if f == "LOCK"]


def test_mid_stream_close_drains(tmp_path):
    """close() with pipelined batches in flight collects them all (acked
    results complete) before tearing the workers down."""
    eng = make_engine(procs=2, wal_dir=str(tmp_path), fsync="never")
    try:
        keys = np.arange(500, dtype=np.uint64)
        eng.put_batch(keys, keys + np.uint64(1))
        pends = [eng.submit(OpBatch.gets(keys)) for _ in range(4)]
    finally:
        eng.close()
    for p in pends:
        found, vals = p.get_results()
        assert found.all()
        assert np.array_equal(vals, keys + np.uint64(1))


def _probe(eng) -> tuple:
    found, vals = eng.get_batch(np.arange(0, 2000, 3, dtype=np.uint64))
    k, v = eng.range_scan(0, UNIVERSE)
    return (found.tobytes(), vals[found].tobytes(), k.tobytes(),
            v.tobytes())


@pytest.mark.parametrize("procs", [0, 2])
def test_wal_recovery_after_procs_run(tmp_path, procs):
    """A worker-mode durable run recovers byte-identically through the
    in-process recovery path and the procs one; the recovered store
    equals the in-process store fed the same stream."""
    want = reference(True, "gloran", False)
    eng = make_engine(procs=2, wal_dir=str(tmp_path), fsync="never")
    assert_same_results(want["results"], drive(eng))
    eng.close()
    twin = make_engine(procs=0, pipeline=False)
    drive(twin)
    rec = recover(str(tmp_path), config=exec_config(True, procs=procs))
    try:
        assert rec.procs == procs
        assert rec.recovery["frames_replayed"] > 0
        assert rec.num_entries == twin.num_entries
        assert _probe(rec) == _probe(twin)
        # The recovered store takes writes onto the same streams.
        rec.put(7, 77)
        assert rec.get(7) == 77
    finally:
        rec.close()
        twin.close()


def test_snapshot_refused_in_procs_mode(tmp_path):
    eng = make_engine(procs=2, wal_dir=str(tmp_path), fsync="never")
    try:
        eng.put(1, 2)
        with pytest.raises(RuntimeError, match="procs"):
            take_snapshot(eng)
    finally:
        eng.close()


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_procs_directory_crosses_packages(tmp_path, writer):
    """A directory written by one package's procs engine recovers in the
    other package's procs engine: lookups and the full scan equal the
    writer's in-process twin."""
    torch_writes = writer == "repro_torch"
    eng = make_engine(torch_writes, procs=2, wal_dir=str(tmp_path),
                      fsync="never")
    drive(eng)
    eng.close()
    twin = make_engine(torch_writes, procs=0, pipeline=False)
    drive(twin)
    fn = jrecover if torch_writes else recover
    rec = fn(str(tmp_path), config=exec_config(not torch_writes, procs=2))
    try:
        assert rec.procs == 2
        assert rec.recovery["frames_replayed"] > 0
        assert _probe(rec) == _probe(twin)
    finally:
        rec.close()
        twin.close()
