"""The spans inside the store's host path and GLORAN's point-lookup
counters, on the CPU.

A small GLORAN engine (LSM buffer 64, T = 4, GLORAN index buffer 16,
EVE capacity 64) with the fused cascade admitted (``kernel_min_batch``
8, so its plain version runs) takes a load of puts and range deletes,
then, under a recording tracer, one write batch with range deletes and
one get batch.  The tests hold the recorded spans to where they must
nest, the counters to a hand count, and the untraced engine to the
traced one's answers.
"""

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.analysis import report
from repro_torch.core import GloranConfig, LSMDRTreeConfig, RAEConfig
from repro_torch.core.eve import EVE
from repro_torch.core.gloran import GloranIndex
from repro_torch.engine import Engine, EngineConfig, OpBatch
from repro_torch.lsm import LSMConfig
from repro_torch.lsm.format import PUT

torch.set_num_threads(1)

UNIVERSE = 1 << 16
RANGE = 40

# Every span this file's tests expect in the traced pair of batches.
NEW_SPANS = ("lsm.get_mem", "shard.cascade", "cascade.upload",
             "cascade.launch", "cascade.copy_back", "lsm.get_levels",
             "gloran.validity", "gloran.eve", "gloran.index_probe",
             "gloran.index_insert", "gloran.index_flush",
             "gloran.eve_insert")
# (child, parent): the child lies inside a parent on its own thread.
NESTING = (("lsm.get_mem", "shard.get"), ("lsm.get_levels", "shard.get"),
           ("gloran.validity", "shard.get"), ("shard.cascade", "shard.get"),
           ("kernel.cascade", "shard.cascade"),
           ("cascade.upload", "kernel.cascade"),
           ("cascade.launch", "kernel.cascade"),
           ("cascade.copy_back", "kernel.cascade"),
           ("gloran.eve", "gloran.validity"),
           ("gloran.index_probe", "gloran.validity"),
           ("gloran.index_insert", "shard.range_delete"),
           ("gloran.eve_insert", "shard.range_delete"),
           ("gloran.index_flush", "gloran.index_insert"))
# Index kinds (the DR-tree, GLORAN0's R-tree) and shard counts.
CASES = [(drtree, shards) for drtree in (True, False) for shards in (1, 2)]
IDS = [f"{'drtree' if d else 'rtree'}-{s}shard" for d, s in CASES]


def make_engine(shards: int = 2, drtree: bool = True, **cfg_kw) -> Engine:
    lsm = LSMConfig(buffer_capacity=64, size_ratio=4, key_size=16,
                    value_size=16, key_universe=UNIVERSE)
    gl = GloranConfig(index=LSMDRTreeConfig(buffer_capacity=16,
                                            size_ratio=4, key_size=16),
                      eve=RAEConfig(capacity=64, key_universe=UNIVERSE),
                      use_drtree=drtree)
    cfg_kw.setdefault("pipeline", False)
    return Engine(shards, strategy="gloran", lsm_config=lsm,
                  gloran_config=gl,
                  config=EngineConfig(device="cpu", kernel_min_batch=8,
                                      kernel_min_areas=1, **cfg_kw))


def write(eng, keys, vals, los) -> None:
    los = np.asarray(los, np.uint64)
    eng.submit(OpBatch.concat([
        OpBatch.puts(keys, vals),
        OpBatch.range_deletes(zip(los.tolist(),
                                  (los + np.uint64(RANGE)).tolist()))
    ])).wait()


class Run:
    """A loaded engine, then one write batch with range deletes and one
    get batch, with the tracer ``tracer`` installed for the pair."""

    def __init__(self, tracer, shards=2, drtree=True, **cfg_kw):
        rng = np.random.default_rng(5)
        self.keys = (rng.choice(UNIVERSE - 2, 1200, replace=False)
                     .astype(np.uint64) + np.uint64(1))
        self.eng = make_engine(shards, drtree, **cfg_kw)
        for i in range(6):
            k = self.keys[i * 200:(i + 1) * 200]
            write(self.eng, k, k * np.uint64(3),
                  rng.integers(1, UNIVERSE - 300, 20))
        # Absent keys beside the loaded ones, none of them loaded.
        absent = np.setdiff1d(rng.integers(1, UNIVERSE - 1, 300)
                              .astype(np.uint64), self.keys)[:200]
        self.query = np.concatenate([self.keys[:400], absent])
        self.before = self.eng.stats().get("gloran")
        with obs.enabled(tracer):
            write(self.eng, self.keys[:50], self.keys[:50],
                  rng.integers(1, UNIVERSE - 300, 40))
            self.found, self.vals = self.eng.submit(
                OpBatch.gets(self.query)).get_results()
        self.after = self.eng.stats().get("gloran")
        self.spans = tracer.events()

    def named(self, name):
        return [s for s in self.spans if s["name"] == name]


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def run(request):
    drtree, shards = request.param
    r = Run(obs.Tracer(), shards=shards, drtree=drtree)
    yield r
    r.eng.close()


def inside(child, parent) -> bool:
    return (child["tid"] == parent["tid"] and parent["t0"] <= child["t0"]
            and child["t1"] <= parent["t1"])


# ---------------------------------------------------------------- spans
def test_every_new_span_is_recorded(run):
    names = {s["name"] for s in run.spans}
    assert set(NEW_SPANS) <= names, sorted(set(NEW_SPANS) - names)
    n_shards = run.eng.num_shards
    # One of each per shard's get sub-batch (the cascade admitted).
    for name in ("lsm.get_mem", "lsm.get_levels", "shard.cascade",
                 "kernel.cascade", "cascade.upload", "cascade.launch",
                 "cascade.copy_back"):
        assert len(run.named(name)) == n_shards, name
    for s in run.spans:
        assert all(isinstance(v, (int, str)) for v in s["attrs"].values())


@pytest.mark.parametrize("child,parent", NESTING,
                         ids=[f"{c}-in-{p}" for c, p in NESTING])
def test_each_span_lies_inside_its_parent(run, child, parent):
    parents = run.named(parent)
    kids = run.named(child)
    assert kids
    for c in kids:
        assert any(inside(c, p) for p in parents), (child, c)


@pytest.mark.parametrize("drtree,shards", CASES, ids=IDS)
def test_view_fold_opens_once_per_fold_inside_the_probe_or_a_flush(
        drtree, shards):
    """The staging buffer folds its pending records on the first probe
    after appends (inside ``gloran.index_probe`` on the point lookups)
    or when a flush drains it (inside ``gloran.index_flush``), with
    integer attributes only."""
    rng = np.random.default_rng(6)
    keys = (rng.choice(UNIVERSE - 2, 600, replace=False).astype(np.uint64)
            + np.uint64(1))
    eng = make_engine(shards, drtree)
    tr = obs.Tracer()
    try:
        with obs.enabled(tr):
            for i in range(3):
                k = keys[i * 200:(i + 1) * 200]
                # 23 range deletes: the index buffer (16) keeps some
                # pending past each write batch's flushes.
                write(eng, k, k, rng.integers(1, UNIVERSE - 300, 23))
                eng.submit(OpBatch.gets(keys[:400])).get_results()
        folds = [s for s in tr.events() if s["name"] == "gloran.view_fold"]
        probes = [s for s in tr.events()
                  if s["name"] == "gloran.index_probe"]
        flushes = [s for s in tr.events()
                   if s["name"] == "gloran.index_flush"]
        assert bool(folds) == drtree
        in_probe = [f for f in folds if any(inside(f, p) for p in probes)]
        assert len(in_probe) == (3 * shards if drtree else 0)
        assert all(sum(inside(f, p) for f in folds) <= 1
                   for p in probes + flushes)
        for f in folds:
            assert set(f["attrs"]) == {"n", "view", "merged"}
            assert all(type(v) is int for v in f["attrs"].values())
            assert 0 <= f["attrs"]["merged"] <= f["attrs"]["n"]
            assert f in in_probe or any(inside(f, p) for p in flushes)
    finally:
        eng.close()


def test_no_new_kernel_span_outside_a_kernel_span(run):
    """``shard.get_ms`` subtracts ``kernel.*`` spans from ``shard.get``:
    the only ``kernel.*`` spans are the wrappers', and no ``cascade.*``
    span lies outside ``kernel.cascade``."""
    kernels = {s["name"] for s in run.spans if s["name"].startswith(
        "kernel.")}
    assert kernels <= {"kernel.cascade", "kernel.bloom", "kernel.interval",
                       "kernel.merge"}
    for s in run.spans:
        if s["name"].startswith("cascade."):
            assert any(inside(s, k) for k in run.named("kernel.cascade"))


def test_trace_report_counts_kernel_launches_only(run):
    tr = obs.Tracer()
    with obs.enabled(tr):
        run.eng.submit(OpBatch.gets(run.query)).get_results()
    ev = tr.chrome_events()
    rep = report.trace_report(ev)
    xs = [e for e in ev if e.get("ph") == "X"]
    kernels = [e for e in xs if e["name"].startswith("kernel.")]
    assert rep["kernel_launches"] == len(kernels) == run.eng.num_shards
    assert sum(e["name"] == "cascade.launch" for e in xs) == len(kernels)
    assert rep["lookups"] == len(run.query)


@pytest.mark.parametrize("drtree,shards", CASES, ids=IDS)
def test_null_tracer_answers_are_identical_and_record_nothing(drtree,
                                                              shards):
    traced = Run(obs.Tracer(), shards=shards, drtree=drtree)
    quiet = Run(obs.NULL_TRACER, shards=shards, drtree=drtree)
    try:
        assert quiet.spans == []
        assert traced.spans
        assert traced.found.tobytes() == quiet.found.tobytes()
        assert traced.vals.tobytes() == quiet.vals.tobytes()
        a, b = traced.eng.stats(), quiet.eng.stats()
        for key in ("io", "kernels", "gloran", "entries"):
            assert a[key] == b[key], key
    finally:
        traced.eng.close()
        quiet.eng.close()


# ------------------------------------------------------------- counters
def newest(tree, key: int):
    """(seq, type) of the newest version of ``key`` in the tree, found by
    hand: the memtable, the frozen memtables newest first, the levels
    top down; None where the tree holds none."""
    if key in tree.mem:
        seq, typ, _ = tree.mem[key]
        return seq, typ
    runs = [(fz.keys, fz.seqs, fz.types) for fz in reversed(tree.frozen)]
    runs += [(lvl.keys, lvl.seqs, lvl.types) for lvl in tree.levels
             if lvl is not None and len(lvl)]
    for keys, seqs, types in runs:
        j = int(np.searchsorted(keys, np.uint64(key)))
        if j < len(keys) and int(keys[j]) == key:
            return int(seqs[j]), int(types[j])
    return None


def test_counters_equal_a_hand_count(run):
    """``lookup_probes``: the queries whose newest version is a put;
    ``eve_maybe``: EVE's verdicts on those (key, seq) pairs, asked again
    of their shard's estimator; ``deleted``: the probes the answer
    leaves out."""
    before = run.eng.stats()["gloran"]
    found, _ = run.eng.submit(OpBatch.gets(run.query)).get_results()
    got = {k: v - before[k] for k, v in run.eng.stats()["gloran"].items()}
    probes = maybe = 0
    for sh in run.eng.shards:
        pairs = [(int(k), hit[0]) for k in run.query
                 for hit in [newest(sh.tree, int(k))]
                 if hit is not None and hit[1] == PUT]
        if pairs:
            k, sq = (np.array(c, np.uint64) for c in zip(*pairs))
            probes += len(pairs)
            maybe += int(sh.tree.gloran.eve.maybe_deleted_batch(k, sq).sum())
    assert got == {"lookup_probes": probes, "eve_maybe": maybe,
                   "deleted": probes - int(found.sum())}
    assert 0 < got["deleted"] <= got["eve_maybe"] <= got["lookup_probes"]
    # The fixture's get batch, on the same state, counted the same.
    assert {k: v - run.before[k] for k, v in run.after.items()} == got
    assert np.array_equal(found, run.found)


def _bottom_compaction(eng):
    for sh in eng.shards:
        t = sh.tree
        last = max(i for i, lvl in enumerate(t.levels)
                   if lvl is not None and len(lvl))
        t._compact(last)


def _scan(eng):
    eng.range_scan_batch([(1, UNIVERSE // 2), (UNIVERSE // 4, UNIVERSE - 1)])


def _drain(eng):
    rng = np.random.default_rng(9)
    k = rng.integers(1, UNIVERSE - 1, 400).astype(np.uint64)
    eng.put_batch(k, k)
    eng.drain()


OTHER_CALLERS = {"bottom_compaction": (_bottom_compaction, "gloran"),
                 "scan": (_scan, "gloran"), "scheduler_drain": (_drain, "eve")}


@pytest.mark.parametrize("caller", sorted(OTHER_CALLERS))
def test_other_callers_of_the_estimator_count_nothing(caller, monkeypatch):
    """The bottom compaction's purge, the scan path and the scheduler's
    density sample reach the same estimator; none of them counts, and
    none opens the point lookups' validity spans."""
    act, reached = OTHER_CALLERS[caller]
    # The trigger turns the scheduler's density sample on.
    run = Run(obs.NULL_TRACER, shards=2, scheduler=True,
              tombstone_trigger=0.9)
    calls = {"gloran": 0, "eve": 0}
    real_batch, real_eve = GloranIndex.is_deleted_batch, \
        EVE.maybe_deleted_batch

    def batch(self, *a, **kw):
        calls["gloran"] += 1
        return real_batch(self, *a, **kw)

    def eve(self, *a, **kw):
        calls["eve"] += 1
        return real_eve(self, *a, **kw)

    try:
        before = run.eng.stats()["gloran"]
        monkeypatch.setattr(GloranIndex, "is_deleted_batch", batch)
        monkeypatch.setattr(EVE, "maybe_deleted_batch", eve)
        tr = obs.Tracer()
        with obs.enabled(tr):
            act(run.eng)
        assert calls[reached] > 0, calls
        assert run.eng.stats()["gloran"] == before
        names = {s["name"] for s in tr.events()}
        assert not names & {"gloran.validity", "gloran.eve",
                            "gloran.index_probe"}, names
    finally:
        run.eng.close()


@pytest.mark.parametrize("procs", [0, 2])
def test_engine_stats_sum_the_shards_and_read_the_same_twice(procs):
    run = Run(obs.NULL_TRACER, shards=2, procs=procs)
    try:
        s1, s2 = run.eng.stats(), run.eng.stats()
        assert s1["gloran"] == s2["gloran"]
        assert s1["gloran"]["lookup_probes"] > 0
        m = s1["metrics"]
        for k, v in s1["gloran"].items():
            assert m[f"gloran.{k}"] == v
        if not procs:
            per = [sh.stats_full()["gloran"] for sh in run.eng.shards]
            assert {k: sum(p[k] for p in per) for k in per[0]} == \
                s1["gloran"]
    finally:
        run.eng.close()
    if procs:
        inproc = Run(obs.NULL_TRACER, shards=2)
        try:
            assert inproc.eng.stats()["gloran"] == s1["gloran"]
        finally:
            inproc.eng.close()


def test_other_strategies_report_no_counters():
    lsm = LSMConfig(buffer_capacity=64, size_ratio=4, key_size=16,
                    value_size=16, key_universe=UNIVERSE)
    eng = Engine(2, strategy="lrr", lsm_config=lsm,
                 config=EngineConfig(device="cpu", pipeline=False))
    try:
        k = np.arange(1, 300, dtype=np.uint64)
        eng.put_batch(k, k)
        eng.get_batch(k)
        assert all(sh.stats_full()["gloran"] is None for sh in eng.shards)
        st = eng.stats()
        assert "gloran" not in st
        assert not any(m.startswith("gloran.") for m in st["metrics"])
    finally:
        eng.close()
