"""Worker processes in ``repro_torch``: spawn safety, the proxy's
limits, error propagation, ``stats()`` idempotency, merged traces, the
workers' launch counts and the absence of any fallback, on the CPU."""

import multiprocessing as mp
import pickle

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.engine import EngineConfig
from repro_torch.engine.procpool import ProcPool, WorkerSpec
from repro_torch.kernels import native
from torch_procs_cells import configs, drive, make_engine

torch.set_num_threads(1)


# ------------------------------------------------- spawn-safety audit
def test_engineconfig_pickle_roundtrip():
    cfg = EngineConfig(device="cpu", procs=3, devices=2, cache_blocks=128,
                       wal_dir="/wal", scheduler=True,
                       tombstone_trigger=0.5, io_wait_s=1e-5,
                       proc_ring_bytes=1 << 20)
    assert pickle.loads(pickle.dumps(cfg)) == cfg


def test_workerspec_pickle_roundtrip():
    lsm, gl = configs(True)
    spec = WorkerSpec(worker_id=1, shard_ids=(1, 3),
                      device_ids=("cuda:0", "cuda:1"), strategy="gloran",
                      lsm_config=lsm, gloran_config=gl,
                      engine_config=EngineConfig(device="cpu"),
                      background=True, wal_dir=None, replay=False,
                      trace=False)
    back = pickle.loads(pickle.dumps(spec))
    assert back.shard_ids == (1, 3)
    assert back.device_ids == ("cuda:0", "cuda:1")
    assert back.lsm_config == lsm
    assert back.gloran_config == gl


@pytest.mark.parametrize("procs,shards,want", [(8, 2, 2), (3, 4, 3),
                                               (0, 4, 0), (None, 4, 0)])
def test_procs_capped_at_num_shards(procs, shards, want):
    eng = make_engine(procs=procs, shards=shards)
    try:
        assert eng.procs == want
        assert (eng._proc_pool is None) == (want == 0)
        keys = np.arange(10, dtype=np.uint64)
        eng.put_batch(keys, keys + np.uint64(1))
        found, vals = eng.get_batch(keys)
        assert found.all() and np.array_equal(vals, keys + np.uint64(1))
    finally:
        eng.close()


# ------------------------------------------------------ the proxy's limits
def test_proc_shard_tree_access_raises():
    eng = make_engine(procs=2)
    try:
        with pytest.raises(RuntimeError, match="worker process"):
            _ = eng.shards[0].tree
    finally:
        eng.close()


def test_worker_error_propagates():
    eng = make_engine(procs=2)
    try:
        with pytest.raises(RuntimeError, match="shard worker"):
            # A malformed control message reaches the worker and its
            # error (not a hang) comes back with the traceback.
            eng.shards[0].worker.request(3, [b"not json"])
        # The worker survives its error and serves the next request.
        eng.put(5, 55)
        assert eng.get(5) == 55
    finally:
        eng.close()


def test_worker_without_its_device_fails_to_start():
    """No fallback: a worker asked for a card it cannot reach refuses to
    start, and the pool raises with the worker's error."""
    lsm, gl = configs(True)
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError,
                       match="failed to start(.|\n)*CUDA is not available"):
        ProcPool(num_shards=2, procs=1, strategy="gloran", lsm_config=lsm,
                 gloran_config=gl, config=EngineConfig(device="cpu"),
                 background=False, device_ids=["cuda:0", "cuda:0"])
    assert not mp.active_children()


# --------------------------------------------------- stats idempotency
def test_stats_idempotent_across_calls():
    """Per-worker ledgers are merged from cumulative snapshots: stats()
    twice with no work between must diff clean."""
    eng = make_engine(procs=2, scheduler=True)
    try:
        drive(eng, rounds=1)
        s1 = eng.stats()
        s2 = eng.stats()
        for key in ("io", "kernels", "entries", "cache", "lsm", "sched",
                    "devices", "procs"):
            assert s1.get(key) == s2.get(key), key
        # Transport counters keep counting (the stats round trips are
        # requests themselves) but never double: one scheduler drain and
        # one STATS a shard.
        assert s2["proc"]["requests"] > s1["proc"]["requests"]
        assert s2["proc"]["requests"] - s1["proc"]["requests"] <= \
            2 * len(eng.shards)
    finally:
        eng.close()


def test_worker_launch_counts():
    """Each worker reports its process's ``native.LAUNCHES``: every
    kernel's name, summed over the workers, zero on the CPU (the plain
    versions launch nothing), and zeroed on request."""
    eng = make_engine(procs=2)
    try:
        drive(eng, rounds=1)
        pool = eng._proc_pool
        rows = pool.launches(per_worker=True)
        assert len(rows) == 2
        assert all(set(r) == set(native.KERNELS) for r in rows)
        total = pool.launches()
        assert total == {k: 0 for k in native.KERNELS}
        pool.reset_launches()
        assert pool.launches() == total
        eng.stats()  # the STATS replies carry them too
        assert sorted(pool.worker_launches) == [0, 1]
    finally:
        eng.close()


# ------------------------------------------------------------ tracing
def test_worker_spans_merge_into_one_trace():
    with obs.enabled() as tr:
        eng = make_engine(procs=2, shards=2)
        try:
            keys = np.arange(64, dtype=np.uint64)
            eng.put_batch(keys, keys + np.uint64(1))
            eng.get_batch(keys)
        finally:
            eng.close()
    ev = tr.chrome_events()
    pnames = {e["args"]["name"] for e in ev if e["name"] == "process_name"}
    assert "repro-engine" in pnames
    assert sum(n.startswith("shard-worker-") for n in pnames) == 2
    worker_spans = [e for e in ev if e.get("ph") == "X" and e["pid"] != 1]
    assert any(e["name"].startswith("shard.") for e in worker_spans)
