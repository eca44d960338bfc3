"""The LRR store (RocksDB's range tombstones, the paper's baseline)
through the port's sharded engine on the CPU, and the spans inside its
tombstone fold, level probes and inserts.

An 8-shard ``lrr`` engine (LSM buffer 48, T = 4, the cascade admitted
from 8 keys, so its plain version runs on a pack with no GLORAN columns)
serves a seeded stream of write batches (puts, then range deletes) and
get batches (half loaded keys, half uniform), with the scheduler on and
off.  Its answers are held to the benchmark's plain reference
(``perfbench/reference``) and, with every shard's ``IOStats``, to the
JAX package's ``lrr`` engine on the same stream; a recording tracer
holds ``lsm.rt_mem``, ``lsm.rt_probe`` and ``lsm.rt_insert`` to where
they must open, and ``lsm.rt_step_merge`` (a flush or compaction that
carries a level block's step function) with them to integer attributes
and to ``lrr`` stores alone.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.engine import Engine as JEngine
from repro.engine import EngineConfig as JEngineConfig
from repro.engine import OpBatch as JOpBatch
from repro.lsm import LSMConfig as JLSMConfig
from repro_torch import obs
from repro_torch.engine import Engine, EngineConfig, OpBatch
from repro_torch.lsm import STRATEGIES, LSMConfig, LSMTree
from repro_torch.lsm.scheduler import CompactionScheduler

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from perfbench.reference import StreamModel, compare_gets  # noqa: E402

torch.set_num_threads(1)

UNIVERSE = 1 << 20
RANGE = 1500
SHARDS = 8
ROUNDS = 10
RT_SPANS = ("lsm.rt_mem", "lsm.rt_probe", "lsm.rt_insert",
            "lsm.rt_step_merge")


def make_engine(torch_side: bool, strategy: str, scheduler: bool):
    lsm = (LSMConfig if torch_side else JLSMConfig)(
        buffer_capacity=48, size_ratio=4, key_size=16, value_size=48,
        block_size=512, key_universe=UNIVERSE)
    kw = {"pipeline": False, "scheduler": scheduler,
          "kernel_min_batch": 8}
    if torch_side:
        return Engine(SHARDS, strategy=strategy, lsm_config=lsm,
                      config=EngineConfig(device="cpu", **kw))
    return JEngine(SHARDS, strategy=strategy, lsm_config=lsm,
                   config=JEngineConfig(procs=0, devices=0, **kw))


def stream(seed: int = 31):
    """Write and get batches: each round one write batch (300 puts of
    loaded keys or, in the first rounds, new ones, with values no other
    batch writes, then 6 range deletes of ``RANGE``) and two get
    batches of 400 keys, half loaded and half uniform."""
    rng = np.random.default_rng(seed)
    keys = rng.choice(UNIVERSE, 2400, replace=False).astype(np.uint64)
    out = []
    for r in range(ROUNDS):
        k = (keys[r * 300:(r + 1) * 300] if r < 8
             else keys[rng.integers(0, len(keys), 300)])
        lo = rng.integers(0, UNIVERSE - RANGE, 6).astype(np.uint64)
        out.append(("write", k, k + np.uint64(1 + (r << 21)), lo,
                    lo + np.uint64(RANGE)))
        for _ in range(2):
            q = np.concatenate([keys[rng.integers(0, len(keys), 200)],
                                rng.integers(0, UNIVERSE, 200)
                                .astype(np.uint64)])
            out.append(("get", rng.permutation(q)))
    return out


def serve(eng, ops, torch_side: bool, on_get=None):
    """Serve the stream; returns (get answers, the reference model)."""
    Op = OpBatch if torch_side else JOpBatch
    model, answers = StreamModel(), []
    for op in ops:
        if op[0] == "write":
            _, k, v, lo, hi = op
            eng.submit(Op.concat([
                Op.puts(k, v),
                Op.range_deletes(zip(lo.tolist(), hi.tolist()))])).wait()
            model.write(k, v, lo, hi)
        else:
            found, vals = eng.submit(Op.gets(op[1])).get_results()
            answers.append((op[1], model.pos, found, vals))
            if on_get is not None:
                on_get(eng)
    return answers, model


def tombstones_at_hand(eng) -> list:
    """Per shard: the memtable's and the sealed memtables' tombstones,
    and the levels whose range-tombstone blocks a lookup probes."""
    out = []
    for sh in eng.shards:
        t = sh.tree
        mem = len(t.mem_rts) + sum(len(fz.rts) for fz in t.frozen)
        blocks = [(i, len(t.level_rts[i])) for i in range(len(t.levels))
                  if i < len(t.level_rts) and len(t.level_rts[i])]
        out.append((mem, blocks))
    return out


class Run:
    """The stream through a traced port engine, with the tombstones each
    shard held at each get batch."""

    def __init__(self, strategy: str, scheduler: bool):
        self.scheduler = scheduler
        self.eng = make_engine(True, strategy, scheduler)
        self.held: list = []
        tracer = obs.Tracer()
        try:
            with obs.enabled(tracer):
                self.answers, self.model = serve(
                    self.eng, stream(), True,
                    lambda e: self.held.append(tombstones_at_hand(e)))
            self.io = [sh.tree.io.snapshot() for sh in self.eng.shards]
            self.cascades = self.eng.kernel_counters.snapshot()[
                "cascade_calls"]
        finally:
            self.eng.close()
        self.spans = tracer.events()

    def named(self, name):
        return [s for s in self.spans if s["name"] == name]

    def inside(self, name, parent):
        return [s for s in self.named(name)
                if s["tid"] == parent["tid"] and parent["t0"] <= s["t0"]
                and s["t1"] <= parent["t1"]]

    def get_steps(self):
        """Per get batch, its ``shard.get`` spans by shard."""
        batches: dict = {}
        for s in self.named("shard.get"):
            batches.setdefault(s["attrs"]["batch"], {})[
                s["attrs"]["shard"]] = s
        return [batches[b] for b in sorted(batches)]


SCHED = [False, True]
SCHED_IDS = ["inline", "scheduler"]


@pytest.fixture(scope="module", params=SCHED, ids=SCHED_IDS)
def lrr(request):
    return Run("lrr", request.param)


@pytest.fixture(scope="module")
def gloran():
    return Run("gloran", True)


# ------------------------------------------------------------- answers
def test_answers_match_the_plain_reference(lrr):
    wrong, n = compare_gets(lrr.model, lrr.answers)
    assert n == ROUNDS * 2 * 400 and wrong == 0
    # The stream really deletes: some loaded keys read as gone.
    assert sum(int((~f).sum()) for _, _, f, _ in lrr.answers) > 0


def test_answers_and_io_match_the_jax_package(lrr):
    ref = make_engine(False, "lrr", lrr.scheduler)
    try:
        answers, _ = serve(ref, stream(), False)
        io = [sh.tree.io.snapshot() for sh in ref.shards]
    finally:
        ref.close()
    for (_, _, f, v), (_, _, rf, rv) in zip(lrr.answers, answers):
        assert np.asarray(f).tobytes() == np.asarray(rf).tobytes()
        assert np.asarray(v)[f].tobytes() == np.asarray(rv)[rf].tobytes()
    assert lrr.io == io
    assert all(s["by_tag"].get("rt_block", 0) > 0 for s in io)


def test_the_cascade_serves_a_pack_without_gloran_columns(lrr):
    assert lrr.cascades > 0
    assert len(lrr.named("kernel.cascade")) == lrr.cascades


# --------------------------------------------------------------- spans
def test_every_get_step_folds_its_tombstones_once(lrr):
    steps = lrr.get_steps()
    assert len(steps) == len(lrr.held) == ROUNDS * 2
    for by_shard, held in zip(steps, lrr.held):
        for shard, step in by_shard.items():
            mem = lrr.inside("lsm.get_mem", step)
            fold = lrr.inside("lsm.rt_mem", step)
            assert len(mem) == len(fold) == 1
            assert lrr.inside("lsm.rt_mem", mem[0]) == fold
            attrs = fold[0]["attrs"]
            assert attrs == {"n": step["attrs"]["n"],
                             "rts": held[shard][0],
                             "built": attrs["built"]}
            assert 0 <= attrs["built"] <= attrs["rts"]
    assert max(s["attrs"]["rts"] for s in lrr.named("lsm.rt_mem")) > 0


def test_a_fold_builds_only_after_a_write(lrr):
    """``built``: each round's first get batch, the first after its
    range deletes, rebuilds some memtable's step function; the second,
    with no write between, finds every one cached."""
    steps = lrr.get_steps()
    for r in range(ROUNDS):
        first, second = (
            [lrr.inside("lsm.rt_mem", step)[0]["attrs"]["built"]
             for step in steps[2 * r + k].values()] for k in (0, 1))
        assert sum(first) > 0 and second == [0] * SHARDS


def test_each_tombstone_block_probe_lies_in_the_level_loop(lrr):
    probed = 0
    for by_shard, held in zip(lrr.get_steps(), lrr.held):
        for shard, step in by_shard.items():
            loop = lrr.inside("lsm.get_levels", step)
            assert len(loop) == 1
            probes = lrr.inside("lsm.rt_probe", step)
            assert probes == lrr.inside("lsm.rt_probe", loop[0])
            # Half the keys are absent, so the loop reaches every level.
            assert [(p["attrs"]["level"], p["attrs"]["rts"])
                    for p in probes] == held[shard][1]
            probed += len(probes)
    rebuilt = {p["attrs"]["rebuilt"] for p in lrr.named("lsm.rt_probe")}
    assert probed > 0 and rebuilt == {0, 1}


def test_each_insert_loop_lies_in_its_range_delete_step(lrr):
    steps = lrr.named("shard.range_delete")
    assert len(steps) == ROUNDS * SHARDS
    for step in steps:
        ins = lrr.inside("lsm.rt_insert", step)
        assert len(ins) == 1 and ins[0]["attrs"] == {"n": 6}
    assert len(lrr.named("lsm.rt_insert")) == len(steps)


@pytest.mark.parametrize("name", RT_SPANS)
def test_the_spans_carry_integer_attributes(lrr, name):
    spans = lrr.named(name)
    assert spans
    assert all(type(v) is int for s in spans for v in s["attrs"].values())


@pytest.mark.parametrize("name", RT_SPANS)
def test_a_gloran_store_opens_none_of_them(gloran, name):
    assert gloran.named("shard.get") and gloran.named("shard.range_delete")
    assert not gloran.named(name)


@pytest.mark.parametrize("strategy",
                         [s for s in STRATEGIES if s != "lrr"])
def test_other_strategies_open_none_of_them(strategy):
    tree = LSMTree(LSMConfig(buffer_capacity=48, size_ratio=4,
                             key_universe=UNIVERSE), strategy=strategy)
    keys = np.arange(1, 400, dtype=np.uint64) * np.uint64(97)
    tracer = obs.Tracer()
    with obs.enabled(tracer):
        tree.put_batch(keys, keys)
        tree.range_delete_arrays(keys[:4], keys[:4] + np.uint64(50))
        tree.get_batch(keys)
    names = {s["name"] for s in tracer.events()}
    assert "lsm.get_mem" in names and not names & set(RT_SPANS)


def test_a_lookup_before_a_seal_is_flushed_folds_its_tombstones():
    """Between a seal and the scheduler's next drain point the sealed
    memtable's tombstones are folded with the active memtable's, and
    the answers are the inline tree's."""
    cfg = LSMConfig(buffer_capacity=48, size_ratio=4, key_universe=UNIVERSE)
    trees = [LSMTree(cfg, strategy="lrr") for _ in range(2)]
    trees[1].scheduler = CompactionScheduler(trees[1])
    # 40 puts and 8 tombstones fill the memtable; 12 more stay active.
    keys = np.arange(1, 41, dtype=np.uint64) * np.uint64(131)
    los = keys[::2]
    for t in trees:
        t.put_batch(keys, keys + np.uint64(5))
        t.range_delete_arrays(los, los + np.uint64(100))
    bg = trees[1]
    assert [len(fz.rts) for fz in bg.frozen] == [8]
    assert len(bg.mem_rts) == 12
    want = len(bg.mem_rts) + sum(len(fz.rts) for fz in bg.frozen)
    tracer = obs.Tracer()
    with obs.enabled(tracer):
        found, vals = bg.get_batch(keys)
    fold = [s for s in tracer.events() if s["name"] == "lsm.rt_mem"]
    assert [s["attrs"] for s in fold] == [{"n": len(keys), "rts": want,
                                           "built": want}]
    f0, v0 = trees[0].get_batch(keys)
    assert found.tobytes() == f0.tobytes() and 0 < found.sum() < len(keys)
    assert vals[found].tobytes() == v0[f0].tobytes()
