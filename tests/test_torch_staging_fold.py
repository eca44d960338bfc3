"""The staging buffer's fold of pending records into its probe view,
against the JAX package's ``repro.core.staging.StagingBuffer`` and
against ``merge_disjoint(old_view, disjointize(pending))``.

Each case appends batches of effective areas, made with numpy from a
seed, and probes after each append; the port's view must equal both
array for array.  The ``gloran.view_fold`` span of each fold must say
how many pending records went through the general merge: those that
overlap or abut a view record or another pending record, counted here
by brute force.
"""

import numpy as np
import pytest

import repro.core as J
import repro_torch.core as T
from repro_torch import obs

CELL_UNIVERSE = 1 << 28


def appends(case: str, rng):
    """The case's batches of (lo, hi, smin, smax) columns."""
    def ranges(n, universe, length):
        lo = rng.integers(0, universe - length.max(), n).astype(np.uint64)
        return lo, lo + length.astype(np.uint64)

    seq = 1
    out = []
    for i in range(10):
        if case == "cell":
            # The benchmark cell's shape: 819 range deletes of 128 keys
            # a write batch, a view of up to ~8k records.
            n = 819
            lo, hi = ranges(n, CELL_UNIVERSE, np.full(n, 128))
            smin = np.zeros(n, np.uint64)
        elif case == "dense":
            # Long deletes over a small universe: most records touch, and
            # the fold is close to the full merge.
            n = 200
            lo, hi = ranges(n, 1 << 14, rng.integers(64, 512, n))
            smin = np.zeros(n, np.uint64)
        elif case == "seam":
            # Records abutting view records or each other with equal
            # (smin, smax): the coalescing seam.  Every record carries
            # the same sequences.
            n = 64
            lo, hi = ranges(n, 1 << 32, np.full(n, 100))
            lo[12:16], hi[12:16] = hi[8:12], hi[8:12] + np.uint64(20)
            if out:
                prev_lo, prev_hi = out[-1][0][:8], out[-1][1][:8]
                lo[:4], hi[:4] = prev_hi[:4], prev_hi[:4] + np.uint64(50)
                lo[4:8], hi[4:8] = prev_lo[4:] - np.uint64(30), prev_lo[4:]
            out.append((lo, hi, np.zeros(n, np.uint64),
                        np.full(n, 7, np.uint64)))
            continue
        elif case == "overlapping":
            # Clusters of pending records that overlap each other, among
            # records that touch nothing.
            centres = np.repeat(rng.integers(0, 1 << 30, 5), 6)
            lo = np.concatenate([
                rng.integers(0, 1 << 30, 90),
                centres + rng.integers(0, 300, 30)]).astype(np.uint64)
            n = len(lo)
            hi = lo + rng.integers(1, 400, n).astype(np.uint64)
            smin = np.zeros(n, np.uint64)
        elif case == "seq_gaps":
            # Short sequence intervals: overlapping areas whose intervals
            # leave a gap drop the older one's coverage.
            n = 150
            lo, hi = ranges(n, 1 << 20, rng.integers(1, 200, n))
            smax = rng.permutation(np.arange(seq, seq + n,
                                             dtype=np.uint64)) + np.uint64(1)
            smin = smax - np.minimum(rng.integers(1, 40, n)
                                     .astype(np.uint64), smax)
            out.append((lo, hi, smin, smax))
            seq += n
            continue
        elif case == "smin_above_0":
            n = 300
            lo, hi = ranges(n, 1 << 24, rng.integers(1, 1000, n))
            smin = rng.integers(1, 50, n).astype(np.uint64)
        smax = np.arange(seq, seq + n, dtype=np.uint64) + np.uint64(50)
        seq += n
        out.append((lo, hi, smin, smax))
    return out


def same(a, b):
    for f in ("lo", "hi", "smin", "smax"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype == np.uint64
        assert x.tobytes() == y.tobytes(), f


def merged_by_hand(view, lo, hi) -> int:
    """Pending records that overlap or abut a view record or another
    pending record, by brute force."""
    near = lambda a0, a1, b0, b1: (a0[:, None] <= b1[None, :]) & (
        b0[None, :] <= a1[:, None])
    pend = near(lo, hi, lo, hi)
    np.fill_diagonal(pend, False)
    hit = pend.any(axis=1)
    if len(view):
        hit |= near(lo, hi, view.lo, view.hi).any(axis=1)
    return int(hit.sum())


CASES = ("cell", "dense", "seam", "overlapping", "seq_gaps", "smin_above_0",
         "flush")


@pytest.mark.parametrize("case", CASES)
def test_fold_matches_the_reference_and_the_full_merge(case):
    rng = np.random.default_rng(CASES.index(case) + 11)
    if case == "flush":
        # ``insert_batch`` chunked across flushes: every flush empties
        # the view, and the next fold starts from an empty one.
        cfg = dict(buffer_capacity=500, size_ratio=3, key_size=16,
                   block_size=512)
        ref = J.LSMDRTree(J.LSMDRTreeConfig(**cfg))
        port = T.LSMDRTree(T.LSMDRTreeConfig(**cfg))
        keys = rng.integers(0, 1 << 16, 2000).astype(np.uint64)
        seq = 0
        for _ in range(12):
            lo = rng.integers(0, (1 << 16) - 64, 230).astype(np.uint64)
            hi = lo + rng.integers(1, 64, 230).astype(np.uint64)
            smax = np.arange(seq + 1, seq + 231, dtype=np.uint64)
            seq += 230
            old = port.buffer._view
            pend_before = port.buffer.size
            ref.insert_batch(lo, hi, smax)
            port.insert_batch(lo, hi, smax)
            qs = rng.integers(0, seq + 1, len(keys)).astype(np.uint64)
            np.testing.assert_array_equal(port.covers_batch(keys, qs),
                                          ref.covers_batch(keys, qs))
            same(port.buffer.view, ref.buffer.view)
            if port.buffer.size == pend_before + 230:  # no flush
                buf = port.buffer
                d = J.disjointize(J.AreaSet(*(
                    c[pend_before:buf.size]
                    for c in (buf._lo, buf._hi, buf._smin, buf._smax))))
                same(port.buffer.view,
                     J.merge_disjoint(old, d) if len(old) else d)
        assert port.epoch == ref.epoch > 0
        for a, b in zip(port.levels, ref.levels):
            assert (a is None) == (b is None)
            if a is not None:
                same(a.areas, b.areas)
        assert port.io.snapshot() == ref.io.snapshot()
        return

    ref, port = J.StagingBuffer(256), T.StagingBuffer(256)
    folds = []
    for lo, hi, smin, smax in appends(case, rng):
        old = port.view
        ref.insert_batch(lo, hi, smin, smax)
        port.insert_batch(lo, hi, smin, smax)
        tr = obs.Tracer()
        with obs.enabled(tr):
            keys = rng.integers(0, int(hi.max()) + 2, 512).astype(np.uint64)
            seqs = rng.integers(0, int(smax.max()) + 2,
                                512).astype(np.uint64)
            got = port.covers_batch(keys, seqs)
        np.testing.assert_array_equal(got, ref.covers_batch(keys, seqs))
        same(port.view, ref.view)
        d = J.disjointize(J.AreaSet(lo, hi, smin, smax))
        same(port.view, J.merge_disjoint(old, d) if len(old) else d)
        assert port.view_records == ref.view.lo.size
        assert port.model_bytes(16) == ref.model_bytes(16)
        (fold,) = [s for s in tr.events() if s["name"] == "gloran.view_fold"]
        assert fold["attrs"] == dict(n=len(lo), view=len(old),
                                     merged=merged_by_hand(old, lo, hi))
        folds.append(fold["attrs"])
    same(port.drain_disjoint(), ref.drain_disjoint())
    assert len(folds) == 10
    # The dense case sends most pending records through the general
    # merge; in the others a few touch something, and only those do.
    share = sum(f["merged"] for f in folds) / sum(f["n"] for f in folds)
    assert share > 0.5 if case == "dense" else 0 < share < 0.5
    if case == "cell":
        assert share < 0.02
