"""The port's host structures (``repro_torch.core``) against ``repro.core``.

The port keeps its own copies of the core structures; these tests hold
the copies to the reference on the same inputs, made with numpy from a
seed: the filter bit contract (``mix32``, ``fold64to32``, ``BloomBits``,
and the int64 torch ``mix32`` the plain kernel versions use),
disjointization, the staging buffer, the LSM-DRtree with its I/O
charges, and ``GloranIndex.is_deleted_batch``.  Integers compare exactly.
"""

import numpy as np
import pytest
import torch

import repro.core as J
import repro.core.eve as jeve
import repro_torch.core as T
import repro_torch.core.eve as teve
from repro_torch.carry import bloom_from_arrays, drtree_from_arrays
from repro_torch.kernels.u32 import mix32 as tmix32

torch.set_num_threads(1)

EDGES = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF],
                 np.uint32)


def random_areas(rng, n, universe=1 << 16, seq=1 << 12):
    lo = rng.integers(0, universe - 64, n).astype(np.uint64)
    hi = lo + rng.integers(1, 64, n).astype(np.uint64)
    smin = rng.integers(0, seq, n).astype(np.uint64)
    smax = smin + rng.integers(1, seq, n).astype(np.uint64)
    return lo, hi, smin, smax


def same_areas(a, b):
    for f in ("lo", "hi", "smin", "smax"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("seed", (0, 1))
def test_mix32_and_fold_bit_contract(seed):
    rng = np.random.default_rng(seed)
    x = np.r_[rng.integers(0, 1 << 32, 5000, dtype=np.uint64)
              .astype(np.uint32), EDGES]
    for s in (0, 0x5EED, 0xFFFFFFFF, int(rng.integers(0, 1 << 32))):
        want = jeve.mix32(x, np.uint32(s))
        np.testing.assert_array_equal(teve.mix32(x, np.uint32(s)), want)
        wide = torch.from_numpy(x.astype(np.int64))
        np.testing.assert_array_equal(tmix32(wide, s).numpy(),
                                      want.astype(np.int64))
    k = np.r_[rng.integers(0, 1 << 63, 5000, dtype=np.uint64),
              np.array([0, (1 << 64) - 1], np.uint64)]
    np.testing.assert_array_equal(teve.fold64to32(k), jeve.fold64to32(k))


@pytest.mark.parametrize("m_bits,hashes", ((4096, 6), (10_007, 3), (64, 1)))
def test_bloom_bits_match(m_bits, hashes):
    rng = np.random.default_rng(m_bits)
    items = rng.integers(0, 1 << 40, m_bits // 10 + 1).astype(np.uint64)
    probe = np.r_[items, rng.integers(0, 1 << 40, 2000).astype(np.uint64)]
    ref = jeve.BloomBits(m_bits, hashes, seed=7)
    port = teve.BloomBits(m_bits, hashes, seed=7)
    ref.insert(items)
    port.insert(items)
    np.testing.assert_array_equal(port.words, ref.words)
    np.testing.assert_array_equal(port.seeds, ref.seeds)
    np.testing.assert_array_equal(port.might_contain(probe),
                                  ref.might_contain(probe))
    carried = bloom_from_arrays(ref.words, ref.m_bits, ref.seeds)
    np.testing.assert_array_equal(carried.might_contain(probe),
                                  ref.might_contain(probe))


@pytest.mark.parametrize("n", (1, 50, 700))
def test_disjointize_matches(n):
    rng = np.random.default_rng(n)
    cols = random_areas(rng, n)
    ref = J.disjointize_arrays(*cols)
    port = T.disjointize_arrays(*cols)
    same_areas(port, ref)
    other = random_areas(rng, n)
    same_areas(T.merge_disjoint(port, T.disjointize_arrays(*other)),
               J.merge_disjoint(ref, J.disjointize_arrays(*other)))


def test_staging_buffer_matches():
    rng = np.random.default_rng(3)
    ref, port = J.StagingBuffer(256), T.StagingBuffer(256)
    keys = rng.integers(0, 1 << 16, 3000).astype(np.uint64)
    seqs = rng.integers(0, 1 << 12, 3000).astype(np.uint64)
    for _ in range(4):
        cols = random_areas(rng, 150)
        ref.insert_batch(cols[0], cols[1], cols[2], cols[3])
        port.insert_batch(cols[0], cols[1], cols[2], cols[3])
        np.testing.assert_array_equal(port.covers_batch(keys, seqs),
                                      ref.covers_batch(keys, seqs))
    same_areas(port.drain_disjoint(), ref.drain_disjoint())
    assert len(port) == len(ref)


def _index_pair(**kw):
    jc = J.LSMDRTreeConfig(buffer_capacity=128, size_ratio=3, key_size=16,
                           block_size=512, **kw)
    tc = T.LSMDRTreeConfig(buffer_capacity=128, size_ratio=3, key_size=16,
                           block_size=512, **kw)
    return J.LSMDRTree(jc), T.LSMDRTree(tc)


def test_lsm_drtree_levels_probes_and_io_match():
    rng = np.random.default_rng(4)
    ref, port = _index_pair()
    seq = 0
    keys = rng.integers(0, 1 << 16, 4000).astype(np.uint64)
    for _ in range(12):
        lo, hi, _, _ = random_areas(rng, 90)
        smax = np.arange(seq + 1, seq + 91, dtype=np.uint64)
        seq += 90
        ref.insert_batch(lo, hi, smax)
        port.insert_batch(lo, hi, smax)
        qs = rng.integers(0, seq + 1, len(keys)).astype(np.uint64)
        np.testing.assert_array_equal(port.covers_batch(keys, qs),
                                      ref.covers_batch(keys, qs))
    assert port.epoch == ref.epoch > 0
    assert len(port.levels) == len(ref.levels)
    for a, b in zip(port.levels, ref.levels):
        assert (a is None) == (b is None)
        if a is not None:
            same_areas(a.areas, b.areas)
            carried = drtree_from_arrays(b.areas.lo, b.areas.hi,
                                         b.areas.smin, b.areas.smax,
                                         key_size=16, block_size=512)
            assert carried.probe_cost() == b.probe_cost()
            qs = rng.integers(0, seq + 1, len(keys)).astype(np.uint64)
            np.testing.assert_array_equal(carried.query_batch(keys, qs),
                                          b.query_batch(keys, qs))
    ref.gc(seq // 2)
    port.gc(seq // 2)
    assert port.io.snapshot() == ref.io.snapshot()


@pytest.mark.parametrize("use_eve", (True, False))
def test_gloran_is_deleted_batch_matches(use_eve):
    rng = np.random.default_rng(5 + use_eve)

    def make(M):
        return M.GloranIndex(M.GloranConfig(
            index=M.LSMDRTreeConfig(buffer_capacity=96, size_ratio=3,
                                    key_size=16, block_size=512),
            eve=M.RAEConfig(capacity=512, key_universe=1 << 16),
            use_eve=use_eve))

    ref, port = make(J), make(T)
    seq = 0
    for r in range(8):
        lo, hi, _, _ = random_areas(rng, 70)
        seqs = np.arange(seq + 1, seq + 71, dtype=np.uint64)
        seq += 70
        ref.range_delete_batch(lo, hi, seqs)
        port.range_delete_batch(lo, hi, seqs)
        if r == 5:
            ref.on_bottom_compaction(seq // 3)
            port.on_bottom_compaction(seq // 3)
        k = rng.integers(0, 1 << 16, 2500).astype(np.uint64)
        s = rng.integers(0, seq + 5, 2500).astype(np.uint64)
        np.testing.assert_array_equal(port.is_deleted_batch(k, s),
                                      ref.is_deleted_batch(k, s))
    assert port.index_epoch == ref.index_epoch
    assert port.io.snapshot() == ref.io.snapshot()
    assert port.buffer_snapshot() == ref.buffer_snapshot()
