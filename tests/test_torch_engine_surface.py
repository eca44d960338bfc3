"""The engine members a user calls, on the CPU, against the reference.

``PendingBatch.done()`` / ``shard_walls`` / ``shard_devices``, the
``devices`` attribute of the ``engine.collect`` span, ``ShardExecutor.
range_delete`` / ``range_delete_batch`` and ``CompactionScheduler.
queue_depth()``: each case drives ``repro_torch.engine.Engine`` and
``repro.engine.Engine`` alike on the reference suites' tiny store
(buffer 32, T = 4, GLORAN index buffer 16, EVE capacity 64) and holds
the port's member to the reference's.
"""

import numpy as np
import pytest
import torch

import repro.obs as jobs
import repro_torch.obs as tobs
from repro.core import GloranConfig as JGloranConfig
from repro.core import LSMDRTreeConfig as JIndexConfig
from repro.core import RAEConfig as JRAEConfig
from repro.engine import Engine as JEngine
from repro.engine import EngineConfig as JEngineConfig
from repro.engine import OpBatch as JOpBatch
from repro.lsm import LSMConfig as JLSMConfig
from repro_torch.core import GloranConfig, LSMDRTreeConfig, RAEConfig
from repro_torch.engine import Engine, EngineConfig, OpBatch
from repro_torch.lsm import LSMConfig

torch.set_num_threads(1)

UNIVERSE = 1 << 16
SIDES = (True, False)  # repro_torch, repro


def make_engine(torch_side: bool, shards: int = 2, **cfg_kw):
    L, G, D, R = ((LSMConfig, GloranConfig, LSMDRTreeConfig, RAEConfig)
                  if torch_side else
                  (JLSMConfig, JGloranConfig, JIndexConfig, JRAEConfig))
    lsm = L(buffer_capacity=32, size_ratio=4, key_size=16, value_size=16,
            key_universe=UNIVERSE)
    gl = G(index=D(buffer_capacity=16, size_ratio=4, key_size=16),
           eve=R(capacity=64, key_universe=UNIVERSE))
    cfg_kw.setdefault("pipeline", False)
    if torch_side:
        cfg, cls = EngineConfig(device="cpu", **cfg_kw), Engine
    else:
        cfg, cls = JEngineConfig(procs=0, devices=0, **cfg_kw), JEngine
    return cls(shards, strategy="gloran", lsm_config=lsm, gloran_config=gl,
               config=cfg)


def load(eng, seed: int = 0, rounds: int = 6) -> np.ndarray:
    """Puts and point deletes over several flushes; returns the keys."""
    rng = np.random.default_rng(seed)
    keys = []
    for i in range(rounds):
        k = rng.integers(1, UNIVERSE - 1, 48).astype(np.uint64)
        eng.put_batch(k, k * np.uint64(2 + i))
        eng.delete_batch(k[:6])
        keys.append(k)
    return np.concatenate(keys)


def get_batch(torch_side: bool, keys: np.ndarray):
    return (OpBatch if torch_side else JOpBatch).gets(keys)


def submitted(torch_side: bool, pipeline: bool):
    """An engine after ``load`` and a submitted get batch, collected."""
    eng = make_engine(torch_side, pipeline=pipeline)
    keys = load(eng)
    pend = eng.submit(get_batch(torch_side, keys))
    found, vals = pend.get_results()
    return eng, pend, (found, vals)


def case_done(pipeline: bool):
    out = []
    for side in SIDES:
        eng, pend, res = submitted(side, pipeline)
        assert pend.done() is True
        # A second batch: ``done`` is True once its shard plans finish,
        # before or without any collection.
        nxt = eng.submit(get_batch(side, res[0].nonzero()[0]
                                   .astype(np.uint64) + 1))
        nxt.wait()
        assert nxt.done() is True
        out.append((res[0].tobytes(), res[1][res[0]].tobytes()))
        eng.close()
    assert out[0] == out[1]


def case_shard_walls():
    walls = []
    for side in SIDES:
        eng, pend, _ = submitted(side, True)
        w = pend.shard_walls
        assert all(v >= 0.0 for v in w.values()), w
        assert isinstance(w, dict) and w is not pend.shard_walls
        walls.append(sorted(w))
        eng.close()
    assert walls[0] == walls[1] == [0, 1]


def case_shard_devices():
    devs = []
    for side in SIDES:
        eng, pend, _ = submitted(side, False)
        d = pend.shard_devices
        assert d == {s: eng.device_map()[s] for s in pend.shard_walls}
        devs.append(d)
        eng.close()
    assert sorted(devs[0]) == sorted(devs[1])
    assert set(devs[0].values()) == {"cpu"}  # the reference's: "host"


def case_collect_span():
    attrs = []
    for side, obs in ((True, tobs), (False, jobs)):
        eng = make_engine(side, pipeline=True)
        keys = load(eng)
        with obs.enabled() as tr:
            eng.submit(get_batch(side, keys)).wait()
        spans = [e for e in tr.events() if e["name"] == "engine.collect"]
        assert len(spans) == 1, spans
        attrs.append(spans[0]["attrs"])
        eng.close()
    assert attrs[0]["devices"] == 1
    assert attrs[0] == attrs[1]


def observe(eng, keys: np.ndarray) -> dict:
    found, vals = eng.get_batch(keys)
    return {"found": found.tobytes(), "vals": vals[found].tobytes(),
            "io": [sh.tree.io.snapshot() for sh in eng.shards],
            "levels": [sh.tree.stats()["levels"] for sh in eng.shards],
            "seq": [int(sh.tree.seq) for sh in eng.shards]}


def case_range_delete():
    """The executor's tuple members against its columnar one, on one
    shard of each package: same gets, ``IOStats`` and level shapes."""
    rng = np.random.default_rng(5)
    los = rng.integers(1, UNIVERSE - 600, 40)
    his = los + rng.integers(1, 600, 40)
    ranges = [(int(a), int(b)) for a, b in zip(los, his)]
    seen = {}
    for side in SIDES:
        for how in ("range_delete", "range_delete_batch",
                    "range_delete_arrays"):
            if not side and how == "range_delete_arrays":
                continue
            eng = make_engine(side, shards=1)
            keys = load(eng)
            sh = eng.shards[0]
            for i in range(0, len(ranges), 8):
                part = ranges[i:i + 8]
                if how == "range_delete":
                    for lo, hi in part:
                        sh.range_delete(lo, hi)
                elif how == "range_delete_batch":
                    sh.range_delete_batch(part)
                else:
                    sh.range_delete_arrays(
                        np.array([r[0] for r in part], np.uint64),
                        np.array([r[1] for r in part], np.uint64))
                keys = np.concatenate([keys, load(eng, seed=i + 1,
                                                  rounds=1)])
            seen[(side, how)] = observe(eng, keys)
            eng.close()
    # Per-call deletes and one batch differ only in how the index
    # absorbs them; each matches the reference's same call.
    assert seen[(True, "range_delete")] == seen[(False, "range_delete")]
    assert seen[(True, "range_delete_batch")] \
        == seen[(True, "range_delete_arrays")] \
        == seen[(False, "range_delete_batch")]
    for a in seen.values():
        assert a["found"] == seen[(False, "range_delete")]["found"]


def case_queue_depth():
    depths = []
    for side in SIDES:
        eng = make_engine(side, scheduler=True)
        rng = np.random.default_rng(3)
        got = []
        for i in range(12):
            k = rng.integers(1, UNIVERSE - 1, 40).astype(np.uint64)
            eng.put_batch(k, k + np.uint64(i))
            # A seal queues its flush; the next plan's start drains it.
            got.append([sh.scheduler.queue_depth() for sh in eng.shards])
            lo = int(rng.integers(1, UNIVERSE - 2000))
            eng.range_delete(lo, lo + int(rng.integers(1, 2000)))
            got.append([sh.scheduler.queue_depth() for sh in eng.shards])
        sched = [sh.scheduler for sh in eng.shards]
        assert [s.queue_depth() for s in sched] \
            == [s.counters()["queue_depth"] for s in sched]
        depths.append(got)
        eng.close()
    assert depths[0] == depths[1]
    assert any(d for row in depths[0] for d in row), depths[0]


CASES = {"done-serial": lambda: case_done(False),
         "done-pipelined": lambda: case_done(True),
         "shard_walls": case_shard_walls,
         "shard_devices": case_shard_devices,
         "collect_span_devices": case_collect_span,
         "executor_range_delete": case_range_delete,
         "scheduler_queue_depth": case_queue_depth}


@pytest.mark.parametrize("case", sorted(CASES))
def test_member_matches_reference(case):
    CASES[case]()
