"""Background compaction in the port: ``repro_torch.engine.Engine`` with
``EngineConfig(scheduler=True)`` on the CPU against the reference's
scheduler-on engine and against the port's own inline engine.

The contract is the reference's (``tests/test_scheduler.py``): jobs run
only at deterministic drain points (plan start, ``drain`` / ``flush`` /
``stats`` / ``close``, seal backpressure), so read results, range scans,
level shapes and contents, sequence numbers and ``IOStats`` are
byte-identical to the inline engine for any sequence of blocking
calls; on top of that the port's job, stall and proactive counts equal
the reference's.
"""

import numpy as np
import pytest
import torch

from repro.core import GloranConfig as JGloranConfig
from repro.core import LSMDRTreeConfig as JIndexConfig
from repro.core import RAEConfig as JRAEConfig
from repro.engine import Engine as JEngine
from repro.engine import EngineConfig as JEngineConfig
from repro.engine import OpBatch as JOpBatch
from repro.lsm import LSMConfig as JLSMConfig
from repro_torch.core import GloranConfig, LSMDRTreeConfig, RAEConfig
from repro_torch.engine import Engine, EngineConfig, OpBatch
from repro_torch.lsm import STRATEGIES, LSMConfig
from torch_engine_cells import COUNTED

torch.set_num_threads(1)

UNIVERSE = 1 << 16
# Counters that are not wall time; stall_seconds is.
SCHED_COUNTS = ("flush_jobs", "cascade_jobs", "proactive_jobs",
                "stall_count", "queue_depth", "max_queue_depth", "frozen",
                "compaction_debt")


def make_engine(torch_side: bool, *, strategy="gloran", shards=2,
                scheduler=False, **cfg_kw):
    """The reference suite's tiny store (buffer 32, T = 4, GLORAN index
    buffer 16) on either package."""
    L, G, D, R = ((LSMConfig, GloranConfig, LSMDRTreeConfig, RAEConfig)
                  if torch_side else
                  (JLSMConfig, JGloranConfig, JIndexConfig, JRAEConfig))
    lsm = L(buffer_capacity=32, size_ratio=4, key_size=16, value_size=16,
            key_universe=UNIVERSE)
    gl = G(index=D(buffer_capacity=16, size_ratio=4, key_size=16),
           eve=R(capacity=64, key_universe=UNIVERSE))
    cfg_kw.setdefault("pipeline", False)
    if torch_side:
        cfg, cls = EngineConfig(device="cpu", scheduler=scheduler,
                                **cfg_kw), Engine
    else:
        cfg = JEngineConfig(procs=0, devices=0, scheduler=scheduler,
                            **cfg_kw)
        cls = JEngine
    return cls(shards, strategy=strategy, lsm_config=lsm, gloran_config=gl,
               config=cfg)


def mixed_ops(seed, n_rounds=6, batch=48):
    """The reference suite's op script: puts, point deletes, gets, range
    deletes, scans and one explicit flush, crossing several flush and
    cascade points."""
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(n_rounds):
        keys = rng.integers(1, UNIVERSE - 1, batch).astype(np.uint64)
        ops.append(("put", keys, keys * np.uint64(2 + i)))
        if i % 2 == 0:
            ops.append(("del", keys[: batch // 4]))
            ops.append(("get", rng.integers(
                1, UNIVERSE - 1, batch).astype(np.uint64)))
        else:
            lo = int(rng.integers(1, UNIVERSE // 2))
            ops.append(("rdel", lo, lo + int(rng.integers(1, 2000))))
            lo = int(rng.integers(1, UNIVERSE - 2))
            ops.append(("scan", lo, lo + 3000))
        if i == n_rounds // 2:
            ops.append(("flush",))
    return ops


def apply_and_compare(engines, ops):
    """Apply the script to every engine; every read op must return the
    same result on all of them."""
    for op in ops:
        outs = []
        for e in engines:
            if op[0] == "put":
                e.put_batch(op[1], op[2])
            elif op[0] == "del":
                e.delete_batch(op[1])
            elif op[0] == "rdel":
                e.range_delete(op[1], op[2])
            elif op[0] == "flush":
                e.flush()
            elif op[0] == "get":
                f, v = e.get_batch(op[1])
                outs.append((f, v[f]))
            else:
                outs.append(e.range_scan(op[1], op[2]))
        for got in outs[1:]:
            for g, w in zip(got, outs[0]):
                assert g.tobytes() == w.tobytes()


def assert_same_store(a, b, *, io=True):
    """Byte-identical visible state and structure (and, by default, the
    cumulative I/O ledger) of two drained engines."""
    probes = np.arange(1, UNIVERSE, 37, dtype=np.uint64)
    fa, va = a.get_batch(probes)
    fb, vb = b.get_batch(probes)
    np.testing.assert_array_equal(fa, fb)
    np.testing.assert_array_equal(va[fa], vb[fb])
    sa, sb = a.range_scan(0, UNIVERSE), b.range_scan(0, UNIVERSE)
    assert sa[0].tobytes() == sb[0].tobytes()
    assert sa[1].tobytes() == sb[1].tobytes()
    for sha, shb in zip(a.shards, b.shards):
        ta, tb = sha.tree, shb.tree
        assert ta.stats()["levels"] == tb.stats()["levels"]
        assert ta.seq == tb.seq
        assert ta.num_entries == tb.num_entries
        for la, lb in zip(ta.levels, tb.levels):
            if la is None or lb is None:
                assert (la is None or len(la) == 0) == \
                       (lb is None or len(lb) == 0)
                continue
            for col in ("keys", "seqs", "types", "vals"):
                np.testing.assert_array_equal(getattr(la, col),
                                              getattr(lb, col))
        if io:
            assert ta.io.snapshot() == tb.io.snapshot()


def io_snapshots(eng) -> list:
    return [sh.tree.io.snapshot() for sh in eng.shards]


def sched_counts(eng) -> list:
    return [{k: sh.scheduler.counters()[k] for k in SCHED_COUNTS}
            for sh in eng.shards]


def kernel_counts(eng) -> dict:
    kc = eng.kernel_counters.snapshot()
    return {k: kc[k] for k in COUNTED}


@pytest.mark.parametrize("shards", (1, 2, 4))
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_background_matches_reference(strategy, shards):
    ours = make_engine(True, strategy=strategy, shards=shards,
                       scheduler=True)
    ref = make_engine(False, strategy=strategy, shards=shards,
                      scheduler=True)
    apply_and_compare([ref, ours], mixed_ops(7, n_rounds=8))
    for e in (ours, ref):
        e.flush()
    assert_same_store(ours, ref)
    assert sched_counts(ours) == sched_counts(ref)
    assert kernel_counts(ours) == kernel_counts(ref)
    for c in sched_counts(ours):
        assert c["queue_depth"] == c["frozen"] == c["compaction_debt"] == 0
        assert c["flush_jobs"] > 0  # the workload really went background
    ours.close()
    ref.close()


@pytest.mark.parametrize("shards", (1, 2, 4))
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_background_matches_inline(strategy, shards):
    inline = make_engine(True, strategy=strategy, shards=shards)
    bg = make_engine(True, strategy=strategy, shards=shards,
                     scheduler=True)
    assert all(sh.scheduler is None for sh in inline.shards)
    apply_and_compare([inline, bg], mixed_ops(7, n_rounds=8))
    inline.flush()
    bg.flush()
    assert_same_store(inline, bg)
    assert kernel_counts(inline) == kernel_counts(bg)
    inline.close()
    bg.close()


@pytest.mark.parametrize("max_frozen", (1, 2, 4))
def test_seal_limits_match_reference(max_frozen):
    """One oversized put batch seals many times inside one plan: past
    ``max_frozen`` every seal backpressures, counted as a stall, as
    often as in the reference, and the store stays the inline one's."""
    inline = make_engine(True, shards=1)
    engines = [make_engine(side, shards=1, scheduler=True,
                           max_frozen=max_frozen) for side in (True, False)]
    rng = np.random.default_rng(11)
    keys = rng.integers(1, UNIVERSE - 1, 600).astype(np.uint64)
    for eng in (inline, *engines):
        eng.put_batch(keys, keys + np.uint64(1))
        eng.range_delete(100, 5000)
        eng.put_batch(keys[:64], keys[:64] + np.uint64(9))
    ours, ref = engines
    for eng in (inline, *engines):
        eng.drain()
    # The ledgers first: every probe below charges I/O.
    assert io_snapshots(inline) == io_snapshots(ours) == io_snapshots(ref)
    assert_same_store(inline, ours, io=False)
    assert_same_store(ours, ref, io=False)
    assert sched_counts(ours) == sched_counts(ref)
    stalls = ours.shards[0].scheduler.counters()["stall_count"]
    # About 18 seals in one plan: past the limit every seal stalls.
    assert stalls > 0
    assert ours.stats()["sched"]["stall_count"] == stalls
    assert ref.stats()["sched"]["stall_count"] == stalls
    for e in (inline, *engines):
        e.close()


def test_proactive_trigger_matches_reference():
    """``tombstone_trigger`` compacts tombstone-dense levels ahead of
    overflow: the port runs the reference's proactive jobs, to the
    reference's level shapes and GLORAN garbage collection, with the
    inline engine's visible results."""
    oracle = make_engine(True, shards=1)
    ours = make_engine(True, shards=1, scheduler=True,
                       tombstone_trigger=0.05)
    ref = make_engine(False, shards=1, scheduler=True,
                      tombstone_trigger=0.05)
    rng = np.random.default_rng(5)
    keys = rng.integers(1, UNIVERSE - 1, 1500).astype(np.uint64)
    for eng in (oracle, ours, ref):
        eng.put_batch(keys, keys * np.uint64(7))
        for j in range(24):  # dense range-delete burst
            lo = 1 + j * (UNIVERSE // 32)
            eng.range_delete(lo, lo + UNIVERSE // 40)
        eng.put_batch(keys[:40], keys[:40] + np.uint64(1))  # plan kick
        eng.drain()
    assert_same_store(ours, ref)
    assert sched_counts(ours) == sched_counts(ref)
    assert sched_counts(ours)[0]["proactive_jobs"] > 0
    go, gr = ours.shards[0].tree.gloran, ref.shards[0].tree.gloran
    assert go.gc_floor == gr.gc_floor
    assert go.index.num_records == gr.index.num_records
    probes = np.arange(1, UNIVERSE, 23, dtype=np.uint64)
    fo, vo = oracle.get_batch(probes)
    f, v = ours.get_batch(probes)
    np.testing.assert_array_equal(f, fo)
    np.testing.assert_array_equal(v[f], vo[fo])
    for e in (oracle, ours, ref):
        e.close()


def test_close_drains_pending_jobs():
    """Pipelined submits, then close(): every queued flush and cascade
    job has run, and the store (I/O ledger included, per shard) is the
    inline engine's and the reference's."""
    inline = make_engine(True, strategy="lrr", shards=4)
    bg = make_engine(True, strategy="lrr", shards=4, scheduler=True,
                     pipeline=True)
    ref = make_engine(False, strategy="lrr", shards=4, scheduler=True,
                      pipeline=True)
    rng = np.random.default_rng(3)
    batches = [rng.integers(1, UNIVERSE - 1, 256).astype(np.uint64)
               for _ in range(6)]
    for i, keys in enumerate(batches):
        inline.put_batch(keys, keys * np.uint64(3 + i))
    inline.range_delete(1000, 9000)
    for eng, ops in ((bg, OpBatch), (ref, JOpBatch)):
        handles = [eng.submit(ops.puts(keys, keys * np.uint64(3 + i)))
                   for i, keys in enumerate(batches)]
        eng.range_delete(1000, 9000)
        eng.close()  # drains in-flight work AND pending scheduler jobs
        assert all(h.wait() is h for h in handles)
    inline.close()
    for c in sched_counts(bg):
        assert c["queue_depth"] == c["frozen"] == c["compaction_debt"] == 0
    assert sched_counts(bg) == sched_counts(ref)
    # The ledgers first: every probe below charges I/O.
    assert io_snapshots(inline) == io_snapshots(bg) == io_snapshots(ref)
    assert_same_store(inline, bg, io=False)
    assert_same_store(bg, ref, io=False)


def test_stats_sched_matches_reference():
    """``stats()`` runs due jobs and rolls the shards' ``sched``
    counters up into ``stats()["sched"]`` and ``sched.*`` metrics, as
    the reference does."""
    out = []
    for side in (True, False):
        eng = make_engine(side, strategy="lrr", shards=2, scheduler=True)
        rng = np.random.default_rng(29)
        keys = rng.integers(1, UNIVERSE - 1, 900).astype(np.uint64)
        eng.put_batch(keys, keys)
        eng.range_delete(10, 9000)
        eng.put_batch(keys[:50], keys[:50])
        out.append(eng.stats())
        eng.close()
    ours, ref = out
    assert {k: ours["sched"][k] for k in SCHED_COUNTS} == \
        {k: ref["sched"][k] for k in SCHED_COUNTS}
    assert ours["sched"]["flush_jobs"] > 0
    assert ours["sched"]["queue_depth"] == 0  # stats() drains first
    m = ours["metrics"]
    assert m["sched.flush_jobs"] == ours["sched"]["flush_jobs"]
    assert "lsm.compaction.bytes.L0" in m
    assert ours["lsm"] == ref["lsm"]
    # An engine without the scheduler reports no sched section.
    plain = make_engine(True, strategy="lrr", shards=2)
    assert "sched" not in plain.stats()
    plain.close()


@pytest.mark.parametrize("strategy", ("gloran", "lrr"))
def test_background_compaction_merge_rank_parity(strategy):
    """Background compaction jobs order their merges through the
    merge-rank hook: with every round gated in, the store equals the
    host-searchsorted inline store, with the reference's merge counts."""
    host = make_engine(True, strategy=strategy, shards=1,
                       use_merge_kernel=False)
    kern = make_engine(True, strategy=strategy, shards=1, scheduler=True,
                       kernel_min_merge=1)
    ref = make_engine(False, strategy=strategy, shards=1, scheduler=True,
                      kernel_min_merge=1)
    apply_and_compare([host, kern, ref], mixed_ops(13, n_rounds=8))
    for e in (host, kern, ref):
        e.flush()
    assert kernel_counts(kern) == kernel_counts(ref)
    assert_same_store(host, kern)
    assert kern.kernel_counters.merge_calls > 0
    assert host.kernel_counters.merge_calls == 0
    for e in (host, kern, ref):
        e.close()


def test_pipelined_background_scans_match_reference():
    """Pipelined mixed batches (puts, a range delete, scans) with the
    scheduler on: each batch's scans equal the inline serial engine's,
    and the store equals the reference's pipelined scheduler-on store.
    Its level shapes may differ from inline ones, in both packages: a
    memtable sealed inside a plan flushes at the next plan's start,
    after the plan's range delete, so GLORAN's bottom-level garbage
    collection sees a later delete than inline."""
    inline = make_engine(True, shards=4)
    engines = [make_engine(side, shards=4, scheduler=True, pipeline=True,
                           max_frozen=1) for side in (True, False)]
    rng = np.random.default_rng(17)
    handles = []
    for i in range(8):
        keys = rng.integers(1, UNIVERSE - 1, 200).astype(np.uint64)
        lo = int(rng.integers(1, UNIVERSE - 4000))
        ops = ([("put", int(k), int(k) + i) for k in keys]
               + [("range_delete", lo, lo + 500),
                  ("range_scan", lo, lo + 4000), ("range_scan", 0, UNIVERSE)])
        want = inline.submit(OpBatch.from_ops(ops)).scan_results()
        handles.append((engines[0].submit(OpBatch.from_ops(ops)),
                        engines[1].submit(JOpBatch.from_ops(ops)), want))
    for ours, ref, want in handles:
        for (gk, gv), (rk, rv), (wk, wv) in zip(
                ours.scan_results(), ref.scan_results(), want):
            assert gk.tobytes() == wk.tobytes() == rk.tobytes()
            assert gv.tobytes() == wv.tobytes() == rv.tobytes()
    ours, ref = engines
    for eng in engines:
        eng.drain()
    assert sched_counts(ours) == sched_counts(ref)
    assert_same_store(ours, ref)
    for e in (inline, *engines):
        e.close()
