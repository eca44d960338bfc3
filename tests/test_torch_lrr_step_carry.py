"""Level tombstone blocks that carry their step function through merges.

``RangeTombstoneBlock.merge`` gives the merged block the
``merge_disjoint`` of its inputs' max-seq step functions where the
larger input's is built, and leaves it lazy otherwise.  Here every
carried function is held byte for byte (``lo``, ``hi``, ``smax``) to
``disjointize`` of the merged block's tombstones: block by block over a
table of input states, over seeded sequences of flushes and compactions
of bare blocks, and in an ``lrr`` tree through a write/get mix, inline
and under the scheduler.  The tree's answers and ``IOStats`` are held to
the same stream on a tree whose merges build lazy blocks (the merge
monkeypatched here), and its ``lsm.rt_probe`` / ``lsm.rt_step_merge``
spans to the merges that did and did not carry.
"""

import sys

import numpy as np
import pytest

from repro_torch import obs
from repro_torch.core.areas import AreaSet
from repro_torch.core.disjointize import disjointize
from repro_torch.lsm import LSMConfig, LSMTree
from repro_torch.lsm.scheduler import CompactionScheduler
from repro_torch.lsm.sstable import RangeTombstoneBlock

CFG = dict(buffer_capacity=64, size_ratio=4, key_size=16, value_size=48,
           block_size=512)
UNIVERSE = 1 << 20


def reference(blk):
    """``disjointize`` of the block's tombstones, as (lo, hi, smax)."""
    s = disjointize(AreaSet(blk.starts, blk.ends,
                            np.zeros(len(blk), np.uint64), blk.seqs))
    return s.lo, s.hi, s.smax


def assert_same(got, want):
    assert [a.dtype for a in got] == [np.dtype(np.uint64)] * 3
    assert [a.tobytes() for a in got] == [a.tobytes() for a in want]


def tombstones(rng, n, seq0, universe=1 << 16):
    """``n`` tombstones with seqs from ``seq0``: a third wide, a third
    nested inside them, a third adjacent to them or short, in a small
    universe so that they overlap."""
    if n == 0:
        z = np.zeros(0, np.uint64)
        return z, z.copy(), z.copy()
    lo = rng.integers(0, universe - 4096, n).astype(np.uint64)
    hi = lo + rng.integers(1, 4096, n).astype(np.uint64)
    k = n // 3
    if k:
        p = rng.integers(0, k, k)
        w = hi[p] - lo[p]
        lo[k:2 * k] = lo[p] + w // 4
        hi[k:2 * k] = lo[k:2 * k] + np.maximum(w // 2, 1)
        q = rng.integers(0, k, n - 2 * k)
        lo[2 * k:] = hi[q]
        hi[2 * k:] = hi[q] + rng.integers(1, 64, n - 2 * k).astype(np.uint64)
    seqs = np.arange(seq0, seq0 + n, dtype=np.uint64)
    order = rng.permutation(n)
    return lo[order], hi[order], seqs[order]


def block(rng, n, seq0, built):
    blk = RangeTombstoneBlock(*tombstones(rng, n, seq0), LSMConfig(**CFG))
    if built and n:
        blk._step_fn()
    return blk


def step_merges(tracer):
    return [s for s in tracer.events() if s["name"] == "lsm.rt_step_merge"]


# (self's tombstones, self built, other's, other built, carried): the
# larger input's function decides; an empty input contributes nothing.
INPUTS = {
    "both-built": (300, True, 80, True, True),
    "larger-built-smaller-lazy": (300, True, 80, False, True),
    "larger-lazy-smaller-built": (300, False, 80, True, False),
    "both-lazy": (300, False, 80, False, False),
    "other-larger-built": (80, False, 300, True, True),
    "other-larger-lazy": (80, True, 300, False, False),
    "equal-self-built": (120, True, 120, False, True),
    "equal-other-built": (120, False, 120, True, False),
    "self-empty-other-built": (0, False, 300, True, True),
    "self-empty-other-lazy": (0, False, 300, False, False),
    "other-empty-self-built": (300, True, 0, False, True),
    "other-empty-self-lazy": (300, False, 0, False, False),
    "both-empty": (0, False, 0, False, False),
}


def newest(blk) -> int:
    return int(blk.seqs.max()) if len(blk) else 0


@pytest.mark.parametrize("older", ["self", "other"])
@pytest.mark.parametrize("case", list(INPUTS))
def test_a_merge_carries_exactly_where_the_larger_input_is_built(
        case, older):
    n_self, b_self, n_other, b_other, carried = INPUTS[case]
    rng = np.random.default_rng(sum(map(ord, case + older)))
    # The older block holds the smaller seqs: a flush merges a newer
    # memtable into level 0, a compaction level i into an older i + 1.
    seq_self, seq_other = (1, 1 + n_self) if older == "self" else \
        (1 + n_other, 1)
    a = block(rng, n_self, seq_self, b_self)
    b = block(rng, n_other, seq_other, b_other)
    tracer = obs.Tracer()
    with obs.enabled(tracer):
        out = a.merge(b)
    assert out.built == carried
    spans = step_merges(tracer)
    if not carried:
        # Lazy as before: nothing built, no span; the first probe builds.
        assert spans == []
        assert (a.built, b.built) == (b_self and n_self > 0,
                                      b_other and n_other > 0)
        if len(out):
            out.max_covering_batch(np.zeros(1, np.uint64))
            assert_same(out._stab, reference(out))
        return
    assert_same(out._stab, reference(out))
    # An empty input holds no newest tombstone: it reads as the older.
    old, new = (a, b) if newest(a) <= newest(b) else (b, a)
    assert [s["attrs"] for s in spans] == [{"old": old.segments,
                                            "new": new.segments,
                                            "out": out.segments}]
    assert all(type(v) is int for v in spans[0]["attrs"].values())
    # The Eq. 1 columns are the concatenation's, sorted by start, as a
    # lazy merge leaves them.
    order = np.argsort(np.concatenate([a.starts, b.starts]), kind="stable")
    for col in ("starts", "ends", "seqs"):
        cat = np.concatenate([getattr(a, col), getattr(b, col)])
        assert getattr(out, col).tobytes() == cat[order].tobytes()


@pytest.mark.parametrize("seed", range(6))
def test_flushes_and_compactions_of_bare_blocks_keep_each_function_exact(
        seed):
    """Level 0 takes a memtable block a flush at a time (probed or not
    between, the memtable's own function built or not), and now and
    then compacts into level 1, which now and then drops to the bottom:
    after every step each level's function, where built, is the
    rebuild's."""
    rng = np.random.default_rng(1000 + seed)
    cfg = LSMConfig(**CFG)
    levels = [RangeTombstoneBlock.empty(cfg), RangeTombstoneBlock.empty(cfg)]
    seq, carried = 1, 0
    for _ in range(40):
        n = int(rng.integers(0, 60))
        mem = block(rng, n, seq, bool(rng.integers(0, 2)))
        seq += n
        if n:
            out = levels[0].merge(mem)
            carried += out.built
            levels[0] = out
        if rng.random() < 0.2:
            out = levels[0].merge(levels[1])
            carried += out.built
            levels = [RangeTombstoneBlock.empty(cfg),
                      out if rng.random() < 0.7
                      else RangeTombstoneBlock.empty(cfg)]
        for blk in levels:
            if len(blk) and rng.random() < 0.6:
                blk.probe_batch(rng.integers(0, 1 << 16, 16, dtype=np.uint64))
            if blk.built:
                assert_same(blk._stab, reference(blk))
    assert carried > 10


# ------------------------------------------------------------ the tree
def stream(seed):
    """Rounds of a write (puts, then overlapping and nested range
    deletes), then 0 to 2 get batches and now and then a scan batch:
    some flushes follow a get, some another write.  Every fourth write
    puts more than a memtable holds, so its puts flush the tombstones
    that the gets before it read."""
    rng = np.random.default_rng(seed)
    loaded = rng.choice(UNIVERSE, 1200, replace=False).astype(np.uint64)
    ops = []
    for r in range(36):
        k = loaded[rng.integers(0, len(loaded), 70 if r % 4 == 3 else 30)]
        ops.append(("put", k, k ^ np.uint64(r + 1)))
        lo, hi, _ = tombstones(rng, 8, 0, UNIVERSE)
        ops.append(("rd", lo, hi))
        for _ in range(int(rng.integers(0, 3))):
            ops.append(("get", np.concatenate([
                loaded[rng.integers(0, len(loaded), 100)],
                rng.integers(0, UNIVERSE, 100).astype(np.uint64)])))
        if r % 6 == 5:
            a = rng.integers(0, UNIVERSE - 8192, 12)
            ops.append(("scan", [(int(x), int(x) + int(w)) for x, w in
                                 zip(a, rng.integers(1, 8192, 12))]))
    return ops


class Served:
    """One stream through one ``lrr`` tree, traced, with every merge of
    a level block logged: (a compaction's, the larger input built,
    self's length, self built, other built, carried), with the merged
    block, and every level block that a get's probe found unbuilt.
    Under the scheduler, flushes wait for a drain after half the
    writes, so gets also read sealed memtables."""

    def __init__(self, scheduler: bool, seed: int, lazy_merge=None):
        # T = 2: four levels, so compactions merge into levels that
        # hold tombstones.
        tree = LSMTree(LSMConfig(**{**CFG, "size_ratio": 2}), strategy="lrr")
        if scheduler:
            tree.scheduler = CompactionScheduler(tree, max_frozen=16)
        self.merges, self.outs, self.rebuilt = [], [], []
        real = RangeTombstoneBlock.merge
        probe = RangeTombstoneBlock.probe_batch

        def logged(blk, other):
            big = blk if len(blk) >= len(other) else other
            site = sys._getframe(1).f_code.co_name
            assert site in ("_flush", "_flush_frozen_one", "_compact_impl")
            state = (site == "_compact_impl", big.built, len(blk), blk.built,
                     other.built)
            out = (lazy_merge or real)(blk, other)
            self.merges.append((*state, out.built))
            self.outs.append(out)
            return out

        def probed(blk, keys, io=None):
            if io is not None and not blk.built:  # a level probe, not
                self.rebuilt.append(blk)        # the compaction's filter
            return probe(blk, keys, io)

        mp = pytest.MonkeyPatch()
        mp.setattr(RangeTombstoneBlock, "merge", logged)
        mp.setattr(RangeTombstoneBlock, "probe_batch", probed)
        self.tracer = obs.Tracer()
        self.answers = []
        drains = np.random.default_rng(seed)
        try:
            with obs.enabled(self.tracer):
                for op in stream(seed):
                    if op[0] == "put":
                        tree.put_batch(op[1], op[2])
                    elif op[0] == "rd":
                        tree.range_delete_arrays(op[1], op[2])
                    elif op[0] == "get":
                        f, v = tree.get_batch(op[1])
                        self.answers.append((f.tobytes(), v[f].tobytes()))
                    else:
                        self.answers.append([
                            (k.tobytes(), v.tobytes())
                            for k, v in tree.range_scan_batch(op[1])])
                    if scheduler and (op[0] == "scan" or op[0] == "rd"
                                      and drains.random() < 0.5):
                        tree.scheduler.drain()
        finally:
            mp.undo()
        self.tree = tree
        self.io = tree.io.snapshot()
        self.spans = self.tracer.events()

    def named(self, name):
        return [s for s in self.spans if s["name"] == name]

    def within(self, span, names):
        return any(p["tid"] == span["tid"] and p["t0"] <= span["t0"]
                   and span["t1"] <= p["t1"]
                   for n in names for p in self.named(n))


def lazy_merge(blk, other):
    """The merge without a carry: every merged block lazy."""
    return RangeTombstoneBlock(np.concatenate([blk.starts, other.starts]),
                               np.concatenate([blk.ends, other.ends]),
                               np.concatenate([blk.seqs, other.seqs]),
                               blk.config)


SCHED = [False, True]
SCHED_IDS = ["inline", "scheduler"]
SEEDS = [7, 8]


@pytest.fixture(scope="module", params=[(s, d) for s in SCHED for d in SEEDS],
                ids=[f"{i}-{d}" for i in SCHED_IDS for d in SEEDS])
def served(request):
    scheduler, seed = request.param
    return (Served(scheduler, seed), Served(scheduler, seed, lazy_merge))


def test_answers_and_io_equal_a_tree_with_lazy_blocks(served):
    carry, lazy = served
    assert len(carry.answers) > 20
    assert carry.answers == lazy.answers
    assert carry.io == lazy.io
    assert carry.io["by_tag"].get("rt_block", 0) > 0
    assert lazy.merges and not any(m[-1] for m in lazy.merges)


def test_every_merge_carries_where_its_larger_input_is_built(served):
    carry, _ = served
    assert [m[-1] for m in carry.merges] == [m[1] for m in carry.merges]
    # Flushes into a probed level 0 and compactions both carry, and
    # some flushes (after a compaction emptied level 0, or with no get
    # between two flushes) stay lazy.
    flush = [m for m in carry.merges if not m[0]]
    assert any(m[-1] for m in flush) and not all(m[-1] for m in flush)
    assert any(m[-1] for m in carry.merges if m[0])
    # Some flushes reuse the memtable block a get built, function and
    # all.
    assert any(m[4] for m in flush)


def test_a_step_merge_span_opens_once_per_carrying_merge(served):
    carry, _ = served
    spans = carry.named("lsm.rt_step_merge")
    assert len(spans) == sum(m[-1] for m in carry.merges)
    flush = ("sched.flush",) if carry.tree.scheduler else ("lsm.flush",)
    in_compact = [s for s in spans if carry.within(s, ("lsm.compact",))]
    in_flush = [s for s in spans if s not in in_compact]
    assert all(carry.within(s, flush) for s in in_flush)
    # Once per carrying flush: every flush into a probed level 0 at
    # least as large as the memtable, and into an empty one of a
    # memtable a get has read.
    assert len(in_flush) == sum(m[-1] for m in carry.merges if not m[0])
    assert len(in_flush) >= sum(1 for m in carry.merges
                                if not m[0] and m[2] and m[1] and m[3])
    assert len(in_compact) == sum(m[-1] for m in carry.merges if m[0])
    for s in spans:
        a = s["attrs"]
        assert set(a) == {"old", "new", "out"} and a["out"] > 0
        assert all(type(v) is int for v in a.values())


def test_only_blocks_no_merge_carried_rebuild_on_their_first_probe(served):
    """``rebuilt=1``: the first probe of a block whose merge stayed
    lazy, once a block; never a block a merge carried."""
    carry, lazy = served
    probes = carry.named("lsm.rt_probe")
    rebuilt = sum(p["attrs"]["rebuilt"] for p in probes)
    assert probes and 0 < rebuilt == len(carry.rebuilt)
    lazily = {id(b) for b, m in zip(carry.outs, carry.merges) if not m[-1]}
    assert len({id(b) for b in carry.rebuilt}) == rebuilt
    assert {id(b) for b in carry.rebuilt} <= lazily
    assert rebuilt <= sum(1 for m in carry.merges if not m[-1])
    lazy_rebuilt = sum(p["attrs"]["rebuilt"]
                       for p in lazy.named("lsm.rt_probe"))
    assert rebuilt < lazy_rebuilt
    # What the carry saves: the rebuilds of blocks that a carry built.
    assert lazy_rebuilt - rebuilt <= sum(m[-1] for m in carry.merges)


def test_each_level_function_is_the_rebuild_of_its_block(served):
    carry, _ = served
    blocks = [b for b in carry.tree.level_rts if len(b)]
    assert blocks and any(b.built for b in blocks)
    for b in blocks:
        if b.built:
            assert_same(b._stab, reference(b))
