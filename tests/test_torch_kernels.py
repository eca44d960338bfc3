"""Each kernel's plain PyTorch version against the JAX package's kernel.

Inputs are made with numpy from a seed and handed to both packages: the
Pallas kernels run as the JAX package's own tests run them on the CPU
(``interpret=True``), beside the numpy oracles (``cascade_np``,
``merge_ranks_np``, ``BloomBits.might_contain``).  Integers compare
exactly.  The edge cases: L in {1, 3, 8} and G in {0, 2}, keys 0 and
0xFFFFFFFE, duplicate keys within a run and across runs, Bloom filters
whose bit count is not a power of two, and clamped sentinel areas.  The
CUDA kernels themselves are held to these plain versions on the card by
``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from repro.core.areas import AreaSet as JAreaSet
from repro.core.eve import BloomBits as JBloomBits
from repro.core.eve import fold64to32 as jfold
from repro.engine.registry import clamp_level_u32 as jclamp
from repro.kernels.bloom.kernel import bloom_probe_pallas
from repro.kernels.cascade.kernel import cascade_pallas
from repro.kernels.cascade.ref import cascade_np
from repro.kernels.interval.kernel import interval_query_pallas
from repro.kernels.merge.kernel import merge_rank_pallas
from repro.kernels.merge.ref import merge_ranks_np
from repro_torch.core.areas import AreaSet
from repro_torch.engine.registry import clamp_level_u32
from repro_torch.kernels.bloom import bloom_probe, bloom_probe_ref
from repro_torch.kernels.cascade import (CascadeState, cascade_lookup,
                                         cascade_masks, cascade_ref)
from repro_torch.kernels.interval import interval_query, interval_query_ref
from repro_torch.kernels.merge import merge_rank, merge_rank_ref, merge_ranks
from repro_torch.kernels.u32 import to_device, to_numpy

torch.set_num_threads(1)

LANES = 128
TILE = 8 * LANES
EDGE = np.array([0, 0xFFFFFFFE], np.uint64)


def tiles(a: np.ndarray, dtype=np.uint32) -> np.ndarray:
    """Zero-pad to a multiple of one (8, 128) tile, reshaped for the
    Pallas kernels."""
    out = np.zeros(-(-len(a) // TILE) * TILE, dtype)
    out[:len(a)] = a
    return out.reshape(-1, LANES)


def t32(a, dtype=np.uint32) -> torch.Tensor:
    return to_device(a, "cpu", dtype)


def np32(t: torch.Tensor, dtype=np.int32) -> np.ndarray:
    return to_numpy(t, dtype)


def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def _areas(rng, n: int, *, clamp_edge: bool):
    """A key-disjoint level of n areas; with ``clamp_edge`` some lo,
    hi, smin and smax lie at or past the u32 ceiling, so that
    ``clamp_level_u32`` drops and clamps them."""
    lo = np.sort(rng.choice(np.arange(0, 1 << 20, 7, dtype=np.uint64), n,
                            replace=False))
    hi = lo + rng.integers(1, 7, n).astype(np.uint64)
    smin = rng.integers(0, 1000, n).astype(np.uint64)
    smax = smin + rng.integers(1, 1 << 20, n).astype(np.uint64)
    if clamp_edge:
        lo = np.concatenate([lo, np.array([0xFFFFFFF0, 1 << 33], np.uint64)])
        hi = np.concatenate([hi, np.array([1 << 34, 1 << 35], np.uint64)])
        smin = np.concatenate([smin, np.array([0, 0], np.uint64)])
        smax = np.concatenate([smax, np.array([1 << 40, 5], np.uint64)])
        smin[:3] = [0, 1 << 33, 0]
        smax[0] = 1 << 36
    return lo, hi, smin, smax


def level_columns(rng, n: int, *, clamp_edge: bool):
    """Clamped u32 columns of one level from both packages (equal)."""
    cols = _areas(rng, n, clamp_edge=clamp_edge)
    ref = jclamp(JAreaSet(*cols))
    port = clamp_level_u32(AreaSet(*cols))
    for a, b in zip(ref[:4], port[:4]):
        np.testing.assert_array_equal(a, b)
    assert ref[4] == port[4]
    return port


def make_pack(rng, L: int, G: int) -> dict:
    """A packed cascade state as host arrays, laid out as the registry
    lays it out: pow2-padded per-level keys (0xFFFFFFFF sentinels), seqs
    and Bloom words; clamped GLORAN columns.  Keys repeat across levels;
    level 0 holds key 0 and the last level 0xFFFFFFFE."""
    lk, ls, wd, koff, kcnt, woff, mb, sd = [], [], [], [], [], [], [], []
    for l in range(L):
        n = int(rng.integers(1, 300))
        keys = np.unique(rng.integers(1, 4000, n).astype(np.uint64))
        if l == 0:
            keys = np.unique(np.r_[keys, np.uint64(0)])
        if l == L - 1:
            keys = np.r_[keys, np.uint64(0xFFFFFFFE)]
        n = len(keys)
        bb = JBloomBits(n * 10 + 13, 6, seed=101 + l)  # non-pow2 m_bits
        bb.insert(keys)
        p = _pow2(n)
        koff.append(sum(len(a) for a in lk))
        kcnt.append(n)
        lk.append(np.r_[keys.astype(np.uint32),
                        np.full(p - n, 0xFFFFFFFF, np.uint32)])
        ls.append(np.r_[rng.integers(1, 1 << 20, n).astype(np.uint32),
                        np.zeros(p - n, np.uint32)])
        woff.append(sum(len(a) for a in wd))
        wd.append(np.r_[bb.words,
                        np.zeros(_pow2(len(bb.words)) - len(bb.words),
                                 np.uint32)])
        mb.append(bb.m_bits)
        sd.append(bb.seeds)
    gl = [level_columns(rng, int(rng.integers(40, 140)),
                        clamp_edge=(g == 0)) for g in range(G)]
    goff = np.cumsum([0] + [len(c[0]) for c in gl[:-1]]) if G else []
    cat = (lambda i: np.concatenate([c[i] for c in gl]) if G
           else np.zeros(1, np.uint32))
    return dict(
        lkeys=np.concatenate(lk), lseqs=np.concatenate(ls),
        key_off=np.array(koff, np.int32), key_cnt=np.array(kcnt, np.int32),
        words=np.concatenate(wd), word_off=np.array(woff, np.int32),
        mbits=np.array(mb, np.uint32), seeds=np.stack(sd),
        glo_lo=cat(0), glo_hi=cat(1), glo_smin=cat(2), glo_smax=cat(3),
        gl_off=np.array(goff, np.int32),
        gl_cnt=np.array([c[4] for c in gl], np.int32))


def queries(rng, host: dict, n: int):
    """Level keys, GLORAN area starts, random keys and the two edges."""
    q = rng.integers(0, 1 << 20, n).astype(np.uint64)
    lk = host["lkeys"][host["lkeys"] != 0xFFFFFFFF]
    q[:n // 3] = lk[rng.integers(0, len(lk), n // 3)]
    if len(host["gl_off"]):
        lo = host["glo_lo"][host["glo_lo"] != 0xFFFFFFFF]
        q[n // 3:n // 2] = lo[rng.integers(0, len(lo), n // 2 - n // 3)]
    q[-2:] = EDGE
    seq = rng.integers(0, 1 << 20, n).astype(np.uint32)
    res = (rng.random(n) < 0.2).astype(np.int32)
    return q, jfold(q), seq, res


@pytest.mark.parametrize("G", (0, 2))
@pytest.mark.parametrize("L", (1, 3, 8))
def test_cascade_plain_matches_pallas_and_oracle(L, G):
    rng = np.random.default_rng(10 * L + G)
    host = make_pack(rng, L, G)
    n = 700
    q, qh, qs, qr = queries(rng, host, n)
    q32 = q.astype(np.uint32)
    want = cascade_np(q32, qh, qs, qr, **host)
    steps_k = int(np.ceil(np.log2(len(host["lkeys"]) + 1))) + 1
    steps_g = int(np.ceil(np.log2(len(host["glo_lo"]) + 1))) + 1
    one = np.zeros(1, np.int32)
    pallas = cascade_pallas(
        tiles(q32), tiles(qh), tiles(qs), tiles(qr, np.int32),
        host["lkeys"], host["lseqs"], host["key_off"], host["key_cnt"],
        host["words"], host["word_off"], host["mbits"], host["seeds"],
        host["glo_lo"], host["glo_hi"], host["glo_smin"], host["glo_smax"],
        host["gl_off"] if G else one, host["gl_cnt"] if G else one,
        L=L, H=6, G=G, steps_keys=steps_k, steps_gl=steps_g,
        interpret=True)
    pallas = [np.asarray(a).reshape(-1)[:n] for a in pallas[:3]] + [
        np.asarray(pallas[3]).reshape(L, -1)[:, :n]]
    state = CascadeState.from_numpy(**host)
    assert (state.L, state.H, state.G) == (L, 6, G)
    got = cascade_masks(t32(q32), t32(qh), t32(qs), t32(qr, np.int32),
                        state)
    assert torch.equal(torch.stack(got[:3]),
                       torch.stack(cascade_ref(t32(q32), t32(qh), t32(qs),
                                               t32(qr, np.int32), state)[:3]))
    for g, p, w in zip(got, pallas, want):
        np.testing.assert_array_equal(np32(g), p)
        np.testing.assert_array_equal(np32(g), w)


def test_cascade_lookup_unpacks_like_reference():
    """The host-array entry point: bitmasks unpack into (n, L) / (n, G)
    verdicts and (n, L) int64 positions."""
    rng = np.random.default_rng(5)
    host = make_pack(rng, 3, 2)
    q, qh, qs, qr = queries(rng, host, 300)
    maybe, hit, gl, pos = cascade_lookup(q.astype(np.uint32), qh, qs,
                                         qr.astype(bool),
                                         CascadeState.from_numpy(**host))
    bm, hm, gm, p = cascade_np(q.astype(np.uint32), qh, qs, qr, **host)
    np.testing.assert_array_equal((maybe << np.arange(3)).sum(1), bm)
    np.testing.assert_array_equal((hit << np.arange(3)).sum(1), hm)
    np.testing.assert_array_equal((gl << np.arange(2)).sum(1), gm)
    np.testing.assert_array_equal(pos, p.T.astype(np.int64))
    assert gl.shape == (300, 2) and pos.dtype == np.int64


@pytest.mark.parametrize("leq", (False, True))
@pytest.mark.parametrize("spread", (8, 5000))
def test_merge_rank_plain_matches_pallas(leq, spread):
    """Dense (spread 8) and sparse keys, duplicates within and across
    runs, and both u32 edges."""
    rng = np.random.default_rng(spread + leq)
    run = np.sort(np.r_[rng.integers(0, spread, 1500), EDGE]
                  ).astype(np.uint32)
    q = np.r_[rng.integers(0, spread + 2, 900), EDGE, run[:50]
              ].astype(np.uint32)
    want = np.searchsorted(run, q, side="right" if leq else "left")
    pallas = np.asarray(merge_rank_pallas(tiles(q), run, leq=leq,
                                          interpret=True)).reshape(-1)
    got = np32(merge_rank(t32(q), t32(run), leq=leq))
    np.testing.assert_array_equal(got, pallas[:len(q)])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np32(merge_rank_ref(t32(q), t32(run), leq=leq)))


def test_merge_ranks_match_host_pair():
    rng = np.random.default_rng(3)
    ka = np.sort(np.r_[rng.integers(0, 40, 700), EDGE]).astype(np.uint32)
    kb = np.sort(np.r_[rng.integers(0, 40, 500), EDGE]).astype(np.uint32)
    pa, pb = merge_ranks(ka, kb, "cpu")
    wa, wb = merge_ranks_np(ka, kb)
    np.testing.assert_array_equal(pa, wa)
    np.testing.assert_array_equal(pb, wb)
    assert pa.dtype == pb.dtype == np.int64
    assert sorted(np.r_[pa, pb].tolist()) == list(range(len(ka) + len(kb)))


@pytest.mark.parametrize("m_bits", (4096, 4093 * 3 + 1, 70_001))
def test_bloom_plain_matches_pallas_and_filter(m_bits):
    rng = np.random.default_rng(m_bits)
    bb = JBloomBits(m_bits, 6, seed=m_bits & 0xFFFF)
    items = rng.integers(0, 1 << 40, max(400, m_bits // 12)).astype(np.uint64)
    bb.insert(items)
    keys = np.r_[items[:400], rng.integers(0, 1 << 40, 400), EDGE
                 ].astype(np.uint64)
    k32 = jfold(keys)
    seeds = tuple(int(s) for s in bb.seeds)
    pallas = np.asarray(bloom_probe_pallas(
        tiles(k32), bb.words, m_bits=bb.m_bits, seeds=seeds,
        interpret=True)).reshape(-1)[:len(keys)]
    got = np32(bloom_probe(t32(k32), t32(bb.words), m_bits=bb.m_bits,
                           seeds=bb.seeds))
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got.astype(bool), bb.might_contain(keys))
    np.testing.assert_array_equal(got, np32(bloom_probe_ref(
        t32(k32), t32(bb.words), m_bits=bb.m_bits, seeds=seeds)))
    assert got[:400].all()  # no false negatives


@pytest.mark.parametrize("clamp_edge", (False, True))
def test_interval_plain_matches_pallas(clamp_edge):
    rng = np.random.default_rng(21 + clamp_edge)
    lo, hi, smin, smax, n = level_columns(rng, 300, clamp_edge=clamp_edge)
    keys = rng.integers(0, 1 << 20, 800).astype(np.uint64)
    keys[:300] = lo[rng.integers(0, n, 300)]
    keys[300:400] = hi[rng.integers(0, n, 100)] - np.uint32(1)
    keys[-2:] = EDGE
    seqs = rng.integers(0, 1 << 20, 800).astype(np.uint32)
    seqs[-1] = 0xFFFFFFFE
    k32 = keys.astype(np.uint32)
    pallas = np.asarray(interval_query_pallas(
        tiles(k32), tiles(seqs), lo, hi, smin, smax,
        interpret=True)).reshape(-1)[:len(keys)]
    cols = [t32(c) for c in (lo, hi, smin, smax)]
    got = np32(interval_query(t32(k32), t32(seqs), *cols))
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(
        got, np32(interval_query_ref(t32(k32), t32(seqs), *cols)))
    assert 0 < got.sum() < len(got)
