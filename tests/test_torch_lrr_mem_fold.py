"""The LRR store's memtable tombstone fold against the per-tombstone loop.

``LSMTree._fold_mem_rts`` answers each key's newest covering memtable
tombstone through one cached max-seq step function per memtable (the
active one and each sealed one).  Here the loop it replaced is kept as
the oracle: every case drives a tree and a twin whose fold is the loop
through the same writes, seals, flushes and get batches, and holds the
fold's covering sequence numbers, the get answers and every ``IOStats``
count byte for byte to the twin's.  ``get`` (key by key) and
``range_scan_batch`` take the same fold, and are held to the twin's
likewise.
"""

import numpy as np
import pytest

from repro_torch.lsm import LSMConfig, LSMTree
from repro_torch.lsm.scheduler import CompactionScheduler

TOP = (1 << 64) - 1
CFG = dict(buffer_capacity=64, size_ratio=4, key_size=16, value_size=48,
           block_size=512)


def loop_fold(tree, keys):
    """The oracle: every memtable tombstone, one masked max each."""
    rt_max = np.zeros(len(keys), dtype=np.uint64)
    for rts in [tree.mem_rts, *(fz.rts for fz in tree.frozen)]:
        for lo, hi, s in rts:
            m = (keys >= lo) & (keys < hi)
            rt_max[m] = np.maximum(rt_max[m], np.uint64(s))
    return rt_max


class LoopTree(LSMTree):
    def _fold_mem_rts(self, keys, rt_max):
        np.maximum(rt_max, loop_fold(self, keys), out=rt_max)


def make(cls, scheduler: bool):
    tree = cls(LSMConfig(**CFG), strategy="lrr")
    if scheduler:
        tree.scheduler = CompactionScheduler(tree, max_frozen=16)
    return tree


def probe_keys(tree, rng, lo=0, hi=1 << 40, n=200):
    """Uniform keys in [lo, hi) plus lo, hi - 1 and hi of every
    tombstone the memtables hold."""
    bounds = [k for rts in [tree.mem_rts, *(fz.rts for fz in tree.frozen)]
              for a, b, _ in rts for k in (a, b - 1, b) if k <= TOP]
    keys = rng.integers(lo, hi, n, dtype=np.uint64, endpoint=False)
    return np.concatenate([keys, np.asarray(bounds, dtype=np.uint64)])


def random_ranges(rng, n, lo=0, span=1 << 40, width=1 << 30):
    """``n`` overlapping, nested and adjacent ranges in
    [lo, lo + span)."""
    q = n // 4
    a = rng.integers(lo, lo + span - 2 * width, n - 2 * q, dtype=np.uint64)
    b = a + rng.integers(1, width, n - 2 * q, dtype=np.uint64)
    rngs = list(zip(a.tolist(), b.tolist()))
    for x, y in rngs[:q]:  # nested inside an earlier range
        rngs.append((x + (y - x) // 4, x + (y - x) // 2 + 1))
    for x, y in rngs[:q]:  # adjacent to an earlier range
        rngs.append((y, y + (y - x)))
    rng.shuffle(rngs)
    return rngs


def puts(rng, n, lo=0, hi=1 << 40):
    k = rng.integers(lo, hi, n, dtype=np.uint64)
    return ("put", k, k ^ np.uint64(0x5A5A))


def rdel(rngs):
    return ("rd", np.asarray([r[0] for r in rngs], np.uint64),
            np.asarray([r[1] for r in rngs], np.uint64))


def case_overlapping(rng):
    return False, [puts(rng, 40), rdel(random_ranges(rng, 16)), ("get",)]


def case_bounds(rng):
    rngs = [(100, 200), (150, 151), (199, 300), (300, 301), (50, 100)]
    return False, [("put", np.arange(40, 320, 7, dtype=np.uint64),
                    np.arange(40, 320, 7, dtype=np.uint64)),
                   rdel(rngs), ("get_at", 0, 400)]


def case_top_of_uint64(rng):
    base = TOP - (1 << 20)
    rngs = random_ranges(rng, 12, lo=base, span=1 << 20, width=1 << 16)
    rngs += [(TOP - 5, TOP), (TOP - 1, TOP)]
    return False, [puts(rng, 30, base, TOP), rdel(rngs),
                   ("get_at", base, TOP), ("get_at", base, TOP)]


def case_frozen_only(rng):
    # Each write fills the memtable exactly: it seals, and the active
    # memtable is left empty.
    ops = []
    for _ in range(3):
        ops += [puts(rng, 24), rdel(random_ranges(rng, 40)), ("get",)]
    return True, ops


def case_no_tombstones(rng):
    return True, [puts(rng, 30), ("get",), puts(rng, 60), ("get",)]


def case_range_delete_between_gets(rng):
    return False, [puts(rng, 20), rdel(random_ranges(rng, 8)), ("get",),
                   ("get",), rdel(random_ranges(rng, 4)), ("get",),
                   ("get",), puts(rng, 50), ("get",)]  # and a flush


def case_seal_and_flush_between_gets(rng):
    return True, [puts(rng, 20), rdel(random_ranges(rng, 12)), ("get",),
                  puts(rng, 50), ("get",),  # a seal by puts
                  rdel(random_ranges(rng, 32)), ("get",),
                  rdel(random_ranges(rng, 64)), ("get",),  # one by deletes
                  ("flush_one",), ("get",), ("drain",), ("get",)]


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}


def drive(case, check):
    """Run ``case``'s writes on a tree and its ``LoopTree`` twin; at each
    of its reads call ``check(tree, twin, keys, written, rng)`` with the
    probe keys of that read and the keys put so far.  Returns the
    tree."""
    rng = np.random.default_rng(sum(map(ord, case)))
    scheduler, ops = CASES[case](rng)
    tree, twin = make(LSMTree, scheduler), make(LoopTree, scheduler)
    written = np.zeros(0, dtype=np.uint64)
    for op in ops:
        if op[0] == "put":
            written = np.concatenate([written, op[1]])
        for t in (tree, twin):
            if op[0] == "put":
                t.put_batch(op[1], op[2])
            elif op[0] == "rd":
                t.range_delete_arrays(op[1], op[2])
            elif op[0] == "flush_one":
                t._flush_frozen_one()
            elif op[0] == "drain":
                t.scheduler.drain()
        if op[0].startswith("get"):
            check(tree, twin, probe_keys(tree, rng, *op[1:]), written, rng)
    return tree


def check_fold_and_batch(tree, twin, keys, written, rng):
    fold = np.zeros(len(keys), dtype=np.uint64)
    tree._fold_mem_rts(keys, fold)
    want = loop_fold(twin, keys)
    assert fold.tobytes() == want.tobytes()
    # Each cached block holds its memtable's tombstones, no others.
    assert len(tree._mem_rt_blk) == len(tree.mem_rts)
    assert [len(fz.rt_blk) for fz in tree.frozen] == \
        [len(fz.rts) for fz in tree.frozen]
    (f, v), (wf, wv) = tree.get_batch(keys), twin.get_batch(keys)
    assert f.tobytes() == wf.tobytes()
    assert v[f].tobytes() == wv[wf].tobytes()
    assert tree.io.snapshot() == twin.io.snapshot()


def check_gets(tree, twin, keys, written, rng):
    """``get`` key by key, on the probe keys and every key put so far:
    answers and I/O equal the twin's."""
    for k in np.r_[keys, written].tolist():
        assert tree.get(k) == twin.get(k), k
    assert tree.io.snapshot() == twin.io.snapshot()


def scan_ranges(tree, keys, rng):
    """Ranges between the points of ``keys`` at random, ranges that
    start, end and straddle at the memtable tombstones' bounds, and a
    few wide ones."""
    pts = np.unique(keys)
    lo = pts[rng.integers(0, len(pts), 48)]
    hi = pts[rng.integers(0, len(pts), 48)]
    rngs = [(int(min(a, b)), int(max(a, b))) for a, b in zip(lo, hi)
            if a != b]
    held = [*tree.mem_rts, *(r for fz in tree.frozen for r in fz.rts)]
    for a, b, _ in held[:24]:
        rngs += [(a, b), (max(a - 1, 0), min(b + 1, TOP)),
                 (a, min(a + 1, TOP))]
    rngs += [(0, TOP), (int(pts[0]), int(pts[-1]))]
    return [(a, b) for a, b in rngs if a < b]


def check_scans(tree, twin, keys, written, rng):
    """``range_scan_batch`` over ranges across the tombstones' bounds
    and the keys put so far: keys, values and I/O equal the twin's."""
    ranges = scan_ranges(tree, np.r_[keys, written], rng)
    got, want = tree.range_scan_batch(ranges), twin.range_scan_batch(ranges)
    assert len(got) == len(want) == len(ranges)
    for (k, v), (wk, wv) in zip(got, want):
        assert k.tobytes() == wk.tobytes()
        assert v.tobytes() == wv.tobytes()
    assert tree.io.snapshot() == twin.io.snapshot()


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_cached_fold_is_the_loop(case):
    tree = drive(case, check_fold_and_batch)
    if case == "frozen_only":
        assert len(tree.frozen) == 3 and not tree.mem_rts
    if case == "seal_and_flush_between_gets":
        assert not tree.frozen and len(tree.level_rts[0])
    if case == "range_delete_between_gets":
        assert not tree.mem_rts and len(tree.level_rts[0])


@pytest.mark.parametrize("case", sorted(CASES))
def test_get_key_by_key_is_the_loop(case):
    drive(case, check_gets)


@pytest.mark.parametrize("case", sorted(CASES))
def test_range_scans_are_the_loop(case):
    drive(case, check_scans)
