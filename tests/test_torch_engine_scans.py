"""Range scans through the port's engine: ``repro_torch.engine.Engine``
on the CPU against ``repro.engine.Engine``.

The same op stream (puts, point deletes and range deletes spread over
the key universe, lookups after every round) drives both engines, then
three batches of range scans: short ranges, long ranges, and edges (a
range deleted just before, ranges past the last key and past the
universe, the whole universe, shard-slab straddlers).  Scan keys and
values byte for byte, lookup results, every shard's ``IOStats``
snapshot and level shapes, and the kernel call and query counts (merge
rounds of the scans, interval stabs of their validity) must be equal,
across 5 strategies x shards {1, 2, 4} x pipeline {on, off} under hash
partitioning; range partitioning is ``test_torch_engine_scans_range.py``
(the files split by partitioning because both pipeline modes share one
reference run).  Then ``execute`` with scans, the batch against the
per-call loop, scan validity through ``interval_query``, the block cache
on repeated scans, ``SessionRegistry.live_pages*`` and the timed-I/O
mode.
"""

import numpy as np
import pytest
import torch

from repro.engine import EngineConfig as JEngineConfig
from repro.runtime.serve_loop import SessionRegistry as JSessionRegistry
from repro_torch.lsm import STRATEGIES
from repro_torch.runtime import SessionRegistry
from torch_engine_cells import (COUNTED, UNIVERSE, assert_same_scans, build,
                                check_scan_cell)

torch.set_num_threads(1)


@pytest.mark.parametrize("pipeline", (True, False))
@pytest.mark.parametrize("shards", (1, 2, 4))
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_scans_match_reference(strategy, shards, pipeline):
    check_scan_cell(strategy, shards, "hash", pipeline)


def _pair(shards: int = 4, **cfg):
    """The port's and the reference's gloran engine on one config, with
    the gates lowered so that every kernel hook takes its calls."""
    gates = dict(kernel_min_batch=1, kernel_min_areas=1,
                 kernel_min_filter=1, kernel_min_merge=1)
    return [build(side, "gloran", shards, True, True, **gates, **cfg)
            for side in (True, False)]


def _counters(eng) -> dict:
    kc = eng.kernel_counters.snapshot()
    return {k: kc[k] for k in COUNTED}


def test_execute_with_mixed_scans():
    """``execute`` routes scans with the other ops (the reference's
    ``test_execute_routes_range_scans``) and agrees with the reference
    on a longer mixed stream."""
    eng, ref = _pair()
    ops = [("put", 5, 50), ("put", 9, 90), ("put", 14, 140),
           ("range_scan", 0, 20), ("range_delete", 0, 10),
           ("range_scan", 0, 20), ("get", 14)]
    res = eng.execute(ops)
    assert res[3][0].tolist() == [5, 9, 14]
    assert res[3][1].tolist() == [50, 90, 140]
    assert res[5][0].tolist() == [14] and res[5][1].tolist() == [140]
    assert res[6] == 140 and res[0] is None and res[4] is None
    ref.execute(ops)
    rng = np.random.default_rng(3)
    ops = []
    for _ in range(600):
        r = rng.random()
        a = int(rng.integers(0, 50_000))
        if r < 0.55:
            ops.append(("put", a, int(rng.integers(1, 1 << 40))))
        elif r < 0.65:
            ops.append(("delete", a))
        elif r < 0.75:
            ops.append(("range_delete", a, a + int(rng.integers(1, 300))))
        elif r < 0.9:
            ops.append(("get", a))
        else:
            ops.append(("range_scan", a, a + int(rng.integers(1, 20_000))))
    got, want = eng.execute(ops), ref.execute(ops)
    for g, w in zip(got, want):
        if isinstance(w, tuple):
            assert_same_scans([[g]], [[w]])
        else:
            assert g == w
    assert _counters(eng) == _counters(ref)
    eng.close()
    ref.close()


def test_empty_range_raises():
    eng, ref = _pair()
    for e in (eng, ref):
        with pytest.raises(ValueError, match="empty range"):
            e.range_scan_batch([(0, 10), (7, 7)])
        e.close()


@pytest.mark.parametrize("partition", ("hash", "range"))
def test_range_scan_batch_equals_per_call_loop(partition):
    eng = build(True, "gloran", 3, True, True, partition=partition)
    rng = np.random.default_rng(9)
    k = rng.integers(0, UNIVERSE, 4000).astype(np.uint64)
    eng.put_batch(k, k + np.uint64(7))
    eng.range_delete_batch([(int(a), int(a) + 500) for a in k[:40]])
    lo = rng.integers(0, UNIVERSE - 40_000, 30)
    ranges = [(int(a), int(a + w))
              for a, w in zip(lo, rng.integers(1, 40_000, 30))]
    ranges.append((0, UNIVERSE))
    batch = eng.range_scan_batch(ranges)
    loop = [eng.range_scan(a, b) for a, b in ranges]
    assert_same_scans([batch], [loop])
    live = dict(zip(k.tolist(), (k + np.uint64(7)).tolist()))
    for a in k[:40].tolist():
        for key in [x for x in live if a <= x < a + 500]:
            live.pop(key)
    want = np.array(sorted(live), np.uint64)
    np.testing.assert_array_equal(batch[-1][0], want)
    np.testing.assert_array_equal(batch[-1][1], want + np.uint64(7))
    eng.close()


def test_scan_validity_goes_through_interval_query():
    """With the gates lowered, GLORAN validity of every scan candidate
    reaches ``interval_query`` (the reference's
    ``test_scan_validity_goes_through_interval_kernel``), with the
    reference's kernel counts."""
    eng, ref = _pair(shards=1)
    keys = np.arange(0, 3000, dtype=np.uint64)
    live = np.ones(3000, dtype=bool)
    for e in (eng, ref):
        e.put_batch(keys, keys + np.uint64(1))
        for lo in range(0, 2400, 4):
            e.range_delete(lo, lo + 2)
        e.flush()
    for lo in range(0, 2400, 4):
        live[lo:lo + 2] = False
    k0 = eng.kernel_counters.interval_calls
    ks, vs = eng.range_scan(0, 3000)
    assert eng.kernel_counters.interval_calls > k0
    np.testing.assert_array_equal(ks, keys[live])
    np.testing.assert_array_equal(vs, keys[live] + np.uint64(1))
    rk, rv = ref.range_scan(0, 3000)
    assert_same_scans([[(ks, vs)]], [[(rk, rv)]])
    assert _counters(eng) == _counters(ref)
    assert [sh.tree.io.snapshot() for sh in eng.shards] == \
        [sh.tree.io.snapshot() for sh in ref.shards]
    eng.close()
    ref.close()


def test_repeated_scans_hit_cache():
    """Scans charge their blocks through the shard's cache: the second
    pass over the same slabs charges less, with the reference's I/O."""
    eng, ref = _pair(cache_blocks=4096)
    keys = np.arange(0, 20_000, dtype=np.uint64)
    ranges = [(int(lo), int(lo) + 900) for lo in range(0, 15_000, 1000)]
    reads = []
    for e in (eng, ref):
        e.put_batch(keys, keys + np.uint64(1))
        e.flush()
        r0 = e.io_reads
        cold = e.range_scan_batch(ranges)
        r1 = e.io_reads
        warm = e.range_scan_batch(ranges)
        reads.append((r1 - r0, e.io_reads - r1))
        assert_same_scans([warm], [cold])
        assert e.cache_snapshot()["hits"] > 0
    assert reads[0] == reads[1] and reads[0][1] < reads[0][0], reads
    snap = eng.cache_snapshot()["by_class"]["range_scan"]
    assert snap == {k: ref.cache_snapshot()["by_class"]["range_scan"][k]
                    for k in snap}
    eng.close()
    ref.close()


def test_live_pages_match_reference():
    """``SessionRegistry.live_pages``/``live_pages_batch`` list the
    pages a session still holds, as the reference's registry does."""
    regs = [SessionRegistry(num_shards=2, device="cpu"),
            JSessionRegistry(num_shards=2, engine_config=JEngineConfig(
                procs=0, devices=0, scheduler=False))]
    sessions = list(range(100, 140))
    for reg in regs:
        for s in sessions:
            pages = np.arange(8 + s % 24)
            reg.register(s, pages, pages + s)
        reg.expire_session(105)
        reg.expire_range(120, 125)
        reg.expire_spans([(130, 132), (135, 136)])
    ours, theirs = (reg.live_pages_batch(sessions) for reg in regs)
    assert_same_scans([ours], [theirs])
    for s, (pages, vals) in zip(sessions, ours):
        dead = s == 105 or 120 <= s < 125 or s in (130, 131, 135)
        assert len(pages) == (0 if dead else 8 + s % 24)
        for reg in regs:
            p1, v1 = reg.live_pages(s)
            np.testing.assert_array_equal(p1, pages)
            np.testing.assert_array_equal(v1, vals)
    regs[0].engine.close()
    regs[1].engine.close()


def test_timed_io_mode_keeps_results_and_ledger():
    """``io_wait_s`` sleeps for each plan step's charged blocks: results
    and ``IOStats`` are those of the count-only engine, the shards' busy
    time holds the waits."""
    import time
    engines = [build(True, "gloran", 2, True, True, io_wait_s=w)
               for w in (0.0, 2e-5)]
    rng = np.random.default_rng(6)
    k = rng.integers(0, UNIVERSE, 3000).astype(np.uint64)
    out = []
    for e in engines:
        e.put_batch(k, k)
        e.flush()
        r0 = e.io_reads
        t0 = time.perf_counter()
        res = e.range_scan_batch([(0, UNIVERSE), (1000, 90_000)])
        out.append((res, e.io_reads - r0, time.perf_counter() - t0))
    (plain, reads, _), (timed, reads2, wall) = out
    assert_same_scans([timed], [plain])
    assert reads == reads2 > 0
    assert wall >= reads * 2e-5 / 2  # two shards wait concurrently
    assert [sh.tree.io.snapshot() for sh in engines[0].shards] == \
        [sh.tree.io.snapshot() for sh in engines[1].shards]
    for e in engines:
        e.close()
