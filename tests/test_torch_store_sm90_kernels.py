"""The store's Hopper kernels, rehearsed on the CPU.

``csrc/cascade_sm90.cu`` and ``csrc/merge_path_sm90.cu`` run only on an
H100; ``chip_smoke.py`` holds them bit-exact to their plain versions
there.  What the CPU can check is checked here, with numpy emulations
laid out as the kernels work:

- the lane-group search of ``csrc/group_search.cuh``: W evenly spaced
  pivots a round, a ballot and a popcount pick the gap, the last round
  hands over the element at the answer; against ``np.searchsorted`` at
  counts 0 to ~450 K, within log_{W+1} rounds;
- ``cascade_sm90``: every (query, level) item searched on its own,
  the Bloom probes in one round, then resolution in level order and the
  GLORAN seq windows; against the JAX package's ``cascade_pallas`` in
  interpret mode and its oracle, and the port's ``cascade_ref``;
- ``merge_path_sm90``: the co-rank split of each tile of diagonals, the
  tile's two input windows, each thread's split of its slots and its
  serial merge; against the JAX package's ``merge_ranks_ref``,
  ``merge_rank_pallas`` in interpret mode and ``merge_positions_ref``;
- that the faults ``chip_smoke.py`` plants (GLORAN stab at lower_bound,
  ties b-first) change the answer on these inputs;
- the wrappers' dispatch, operand checks and build from ``csrc/``.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.eve import BloomBits as JBloomBits
from repro.kernels.cascade.kernel import cascade_pallas
from repro.kernels.cascade.ref import cascade_np
from repro.kernels.merge.kernel import merge_rank_pallas
from repro.kernels.merge.ref import merge_ranks_ref
from repro_torch.core.eve import mix32
from repro_torch.engine import Engine, EngineConfig
from repro_torch.kernels import native
from repro_torch.kernels.cascade import CascadeState, cascade_masks
from repro_torch.kernels.cascade import cascade_ref
from repro_torch.kernels.cascade import ops as cascade_ops
from repro_torch.kernels.merge import merge_positions, merge_positions_ref
from repro_torch.kernels.merge import merge_ranks
from repro_torch.kernels.merge import ops as merge_ops
from repro_torch.kernels.u32 import to_device, to_numpy

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
LANES = 128
TILE_ROWS = 8 * LANES
EDGE = np.array([0, 0xFFFFFFFE], np.uint64)
U32 = np.uint32


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# The cascade pack and query builders of the plain-version tests.
TK = _load("torch_kernel_tests", ROOT / "tests" / "test_torch_kernels.py")
CS = _load("chip_smoke", ROOT / "chip_smoke.py")


def tiles(a: np.ndarray, dtype=U32) -> np.ndarray:
    out = np.zeros(-(-len(a) // TILE_ROWS) * TILE_ROWS, dtype)
    out[:len(a)] = a
    return out.reshape(-1, LANES)


# ------------------------------------------- group_search.cuh, emulated
def group_search(lo, hi, before, W: int):
    """Lane-group searches of (n,) ranges at once: the first index of
    [lo, hi) at which ``before`` is false.  ``before(p)`` takes (n, W)
    pivot indices (every lane's pivot of every search) and returns the
    (n, W) verdicts and the (n, W) words the lanes loaded.

    Returns (answer, word at the answer or 0, rounds of each search)."""
    lo = np.asarray(lo, np.int64).copy()
    hi = np.asarray(hi, np.int64).copy()
    n = len(lo)
    rows = np.arange(n)
    at = np.zeros(n, np.uint32)
    rounds = np.zeros(n, np.int64)
    lane = np.arange(W, dtype=np.int64)
    while True:
        act = lo < hi
        if not act.any():
            return lo, at, rounds
        length = hi - lo
        piv = lo[:, None] + (lane + 1)[None, :] * length[:, None] // (W + 1)
        b, x = before(piv)
        k = np.where(act, (b & act[:, None]).sum(1), 0)  # popc(ballot)
        xk = x[rows, np.minimum(k, W - 1)]               # shfl from lane k
        below = piv[rows, np.maximum(k - 1, 0)] + 1
        above = piv[rows, np.minimum(k, W - 1)]
        lo = np.where(act & (k > 0), below, lo)
        at = np.where(act & (k < W), xk, at)
        hi = np.where(act & (k < W), above, hi)
        rounds += act


def gather(a: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """a[idx], with indices past either end (pivots of finished
    searches) read as 0: those lanes' words are never used."""
    if not len(a):
        return np.zeros(idx.shape, a.dtype)
    return np.where((idx >= 0) & (idx < len(a)),
                    a[np.clip(idx, 0, len(a) - 1)], 0).astype(a.dtype)


def group_bound(a, lo, hi, q, W: int, *, upper: bool):
    """``group_bound``: lower (``upper`` False) or upper bound of each q
    in a[lo:hi)."""
    q = np.asarray(q, np.uint32)[:, None]

    def before(p):
        x = gather(a, p)
        return (x <= q) if upper else (x < q), x
    return group_search(lo, hi, before, W)


def round_limit(count: int, W: int) -> int:
    """Each round leaves at most floor(len / (W + 1)) of the range."""
    r, length = 0, count
    while length:
        length //= W + 1
        r += 1
    return r


COUNTS = (0, 1, 31, 32, 33, 1023, 1024, 1025, 450_000)


@pytest.mark.parametrize("upper", (False, True), ids=("lower", "upper"))
@pytest.mark.parametrize("W", (8, 16, 32))
@pytest.mark.parametrize("count", COUNTS)
def test_group_search_matches_searchsorted(count, W, upper):
    rng = np.random.default_rng(count * 7 + W + upper)
    a = np.sort(rng.integers(0, max(count // 3, 2), count)).astype(U32)
    a[-1:] = 0xFFFFFFFE if count > 2 else a[-1:]
    off = 5  # a segment of a longer array, as a level of a pack
    flat = np.r_[np.full(off, 7, U32), a, np.full(3, 0xFFFFFFFF, U32)]
    q = np.r_[rng.integers(0, max(count // 3, 2) + 2, 400), a[::max(1, count
              // 200)], EDGE].astype(U32)
    lo = np.full(len(q), off)
    got, at, rounds = group_bound(flat, lo, lo + count, q, W, upper=upper)
    want = np.searchsorted(a, q, side="right" if upper else "left")
    np.testing.assert_array_equal(got - off, want)
    inside = want < count
    np.testing.assert_array_equal(at[inside], a[want[inside]])
    assert rounds.max(initial=0) <= round_limit(count, W)
    if count == 450_000 and W == 32:
        assert rounds.max() == 4  # the 32-ary search's 4 rounds, not 19


# -------------------------------------------------- cascade, emulated
def cascade_sm90_emulation(q, qh, qseq, qres, host, *, W: int = 32,
                           lower_stab: bool = False):
    """``cascade_sm90`` on host arrays laid out as ``CascadeState``:
    every (query, SSTable level) and (query, GLORAN level) item answered
    on its own (the kernel runs them concurrently), then the block's
    resolution step in level order.  Returns (bloom, hit, gl, pos)."""
    q = np.asarray(q, np.uint64).astype(U32)
    qh = np.asarray(qh, U32)
    n = len(q)
    lkeys, lseqs, words = (np.asarray(host[k], U32)
                           for k in ("lkeys", "lseqs", "words"))
    seeds = np.asarray(host["seeds"], U32)
    L, H = seeds.shape
    G = len(host["gl_off"])
    bloom = np.zeros(n, np.int32)
    hit = np.zeros(n, np.int32)
    pos = np.zeros((L, n), np.int32)
    hit_seq = np.zeros((n, max(L, 1)), U32)
    for l in range(L):
        # One round of Bloom probes: lane h computes probe h.
        p = mix32(np.broadcast_to(qh[:, None], (n, H)),
                  seeds[l][None, :]) % U32(host["mbits"][l])
        w = words[int(host["word_off"][l]) + (p >> U32(5)).astype(np.int64)]
        maybe = (((w >> (p & U32(31))) & U32(1)) == 1).all(1)
        off, cnt = int(host["key_off"][l]), int(host["key_cnt"][l])
        lb, at, _ = group_bound(lkeys, np.full(n, off), np.full(n, off + cnt),
                                q, W, upper=False)
        lb -= off
        pos[l] = np.minimum(lb, cnt - 1)
        h = maybe & (lb < cnt) & (at == q)  # the last round's element
        bloom |= maybe.astype(np.int32) << l
        hit |= h.astype(np.int32) << l
        hit_seq[h, l] = lseqs[off + lb[h]]
    stab = []
    for g in range(G):
        off, cnt = int(host["gl_off"][g]), int(host["gl_cnt"][g])
        lo = np.asarray(host["glo_lo"], U32)
        j, _, _ = group_bound(lo, np.full(n, off),
                              np.full(n, off + max(cnt, 0)), q, W,
                              upper=not lower_stab)
        j -= 1
        ok = (cnt > 0) & (j >= off)
        jc = np.where(ok, j, 0)
        inside = ok & (q < np.asarray(host["glo_hi"], U32)[jc])
        stab.append((inside, np.asarray(host["glo_smin"], U32)[jc],
                     np.asarray(host["glo_smax"], U32)[jc]))
    # Resolution: the first hit in level order, unless the memtable did.
    first = np.zeros(n, np.int64)
    for l in reversed(range(L)):
        first = np.where((hit >> l) & 1 == 1, l, first)
    res = np.where((np.asarray(qres) == 0) & (hit != 0),
                   hit_seq[np.arange(n), first], np.asarray(qseq, U32))
    gl = np.zeros(n, np.int32)
    for g, (inside, smin, smax) in enumerate(stab):
        cov = inside & (smin <= res) & (res < smax)
        gl |= cov.astype(np.int32) << g
    return bloom, hit, gl, pos


def area_queries(rng, host, q, qs, qr):
    """A quarter of the queries set to area starts, resolved with a seq
    inside the area's window: a wrong stab at the boundary shows."""
    if not len(host["gl_off"]) or not host["gl_cnt"].sum():
        return q, qs, qr
    q, qs, qr = q.copy(), qs.copy(), qr.copy()
    live = np.flatnonzero(np.asarray(host["glo_lo"], U32) != 0xFFFFFFFF)
    k = live[rng.integers(0, len(live), len(q) // 4)]
    sl = slice(len(q) // 2, len(q) // 2 + len(k))
    q[sl] = host["glo_lo"][k]
    qs[sl] = host["glo_smin"][k]
    qr[sl] = 1
    return q, qs, qr


@pytest.mark.parametrize("G", (0, 2))
@pytest.mark.parametrize("L", (1, 3, 8))
def test_cascade_emulation_matches_pallas_and_oracle(L, G):
    rng = np.random.default_rng(10 * L + G)
    host = TK.make_pack(rng, L, G)
    q, qh, qs, qr = TK.queries(rng, host, 700)
    q, qs, qr = area_queries(rng, host, q, qs, qr)
    q32 = q.astype(U32)
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
    pallas = [np.asarray(a).reshape(-1)[:700] for a in pallas[:3]] + [
        np.asarray(pallas[3]).reshape(L, -1)[:, :700]]
    oracle = cascade_np(q32, qh, qs, qr, **host)
    for W in (8, 16, 32):
        got = cascade_sm90_emulation(q, qh, qs, qr, host, W=W)
        for g, p, o in zip(got, pallas, oracle):
            np.testing.assert_array_equal(g, p)
            np.testing.assert_array_equal(g, o)
    if G:
        assert got[2].any()  # some keys at area starts are covered


def _level(keys: np.ndarray, rng, l: int):
    """One packed level's arrays (pow2-padded keys and words)."""
    n = len(keys)
    bb = JBloomBits(n * 10 + 13, 6, seed=301 + l)
    bb.insert(keys.astype(np.uint64))
    p = TK._pow2(max(n, 1))
    return (np.r_[keys.astype(U32), np.full(p - n, 0xFFFFFFFF, U32)],
            np.r_[rng.integers(1, 1 << 20, n).astype(U32),
                  np.zeros(p - n, U32)],
            np.r_[bb.words, np.zeros(TK._pow2(len(bb.words)) - len(bb.words),
                                     U32)], bb.m_bits, bb.seeds)


def edge_pack(rng, counts, areas):
    """A pack with levels of the given entry counts (0 is an empty level,
    one sentinel slot) and GLORAN levels of the given area counts (0 is
    an empty level)."""
    lk, ls, wd, koff, kcnt, woff, mb, sd = ([] for _ in range(8))
    for l, c in enumerate(counts):
        keys = np.sort(rng.choice(np.arange(1, 1 << 22, dtype=np.uint64), c,
                                  replace=False))
        k, s, w, m, seeds = _level(keys, rng, l)
        koff.append(sum(map(len, lk)))
        kcnt.append(c)
        woff.append(sum(map(len, wd)))
        for col, x in zip((lk, ls, wd, mb, sd), (k, s, w, m, seeds)):
            col.append(x)
    gl = [TK.level_columns(rng, a, clamp_edge=False) if a else
          (np.zeros(0, U32),) * 4 + (0,) for a in areas]
    return dict(
        lkeys=np.concatenate(lk), lseqs=np.concatenate(ls),
        key_off=np.array(koff, np.int32), key_cnt=np.array(kcnt, np.int32),
        words=np.concatenate(wd), word_off=np.array(woff, np.int32),
        mbits=np.array(mb, U32), seeds=np.stack(sd),
        glo_lo=np.concatenate([c[0] for c in gl] + [np.zeros(1, U32)]),
        glo_hi=np.concatenate([c[1] for c in gl] + [np.zeros(1, U32)]),
        glo_smin=np.concatenate([c[2] for c in gl] + [np.zeros(1, U32)]),
        glo_smax=np.concatenate([c[3] for c in gl] + [np.zeros(1, U32)]),
        gl_off=np.cumsum([0] + [len(c[0]) for c in gl[:-1]]).astype(np.int32),
        gl_cnt=np.array([c[4] for c in gl], np.int32))


@pytest.mark.parametrize("counts,areas", [
    ((1, 31, 32, 33), (1, 0)),
    ((1023, 1024, 1025), (0,)),
    ((450_000,), (8192,)),
    ((5, 1, 2), (40, 1, 0)),
], ids=("small", "tile-edges", "450K", "empty-gloran"))
def test_cascade_emulation_edges_match_plain_and_oracle(counts, areas):
    rng = np.random.default_rng(sum(counts) + len(areas))
    host = edge_pack(rng, counts, areas)
    q, qh, qs, qr = TK.queries(rng, host, 1500)
    q, qs, qr = area_queries(rng, host, q, qs, qr)
    want = cascade_np(q.astype(U32), qh, qs, qr, **host)
    st = CascadeState.from_numpy(device="cpu", **host)
    plain = cascade_ref(*(to_device(x, "cpu", t) for x, t in
                          ((q, U32), (qh, U32), (qs, U32), (qr, np.int32))),
                        st)
    got = cascade_sm90_emulation(q, qh, qs, qr, host, W=32)
    for g, w, p in zip(got, want, plain):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, to_numpy(p, np.int32))
    assert got[1].any()


def test_cascade_empty_level_has_no_hit_and_pos_minus_one():
    """Empty SSTable levels (held to the port's plain version: the JAX
    package's numpy oracle indexes an empty slice there and raises) and
    an empty GLORAN level."""
    rng = np.random.default_rng(4)
    host = edge_pack(rng, (0, 700, 0), (0, 30))
    q, qh, qs, qr = TK.queries(rng, host, 400)
    bloom, hit, gl, pos = cascade_sm90_emulation(q, qh, qs, qr, host, W=8)
    assert (pos[0] == -1).all() and (pos[2] == -1).all()
    assert not (hit & 0b101).any() and (hit & 0b010).any()
    assert not (gl & 1).any()
    st = CascadeState.from_numpy(device="cpu", **host)
    plain = cascade_masks(*(to_device(x, "cpu", t) for x, t in
                            ((q, U32), (qh, U32), (qs, U32),
                             (qr, np.int32))), st)
    for g, p in zip((bloom, hit, gl, pos), plain):
        np.testing.assert_array_equal(g, to_numpy(p, np.int32))


@pytest.mark.parametrize("W", (8, 32))
def test_cascade_lower_bound_stab_is_caught_at_area_starts(W):
    """The fault chip_smoke.py plants in cascade_sm90 (the GLORAN stab at
    lower_bound - 1) changes the coverage of keys equal to an area's
    start, which these queries hold."""
    rng = np.random.default_rng(9)
    host = TK.make_pack(rng, 3, 2)
    q, qh, qs, qr = TK.queries(rng, host, 600)
    q, qs, qr = area_queries(rng, host, q, qs, qr)
    good = cascade_sm90_emulation(q, qh, qs, qr, host, W=W)
    bad = cascade_sm90_emulation(q, qh, qs, qr, host, W=W, lower_stab=True)
    np.testing.assert_array_equal(good[0], bad[0])
    assert (good[2] != bad[2]).any()


# ---------------------------------------------------- merge, emulated
MERGE_THREADS, MERGE_ITEMS = 256, 8
MERGE_TILE = MERGE_THREADS * MERGE_ITEMS


def merge_path_emulation(a, b, *, b_first: bool = False,
                         threads: int = MERGE_THREADS,
                         items: int = MERGE_ITEMS):
    """``merge_path_sm90``: int32 (na + nb,) merged slots, a's first.
    Per tile of ``threads * items`` diagonals: the co-rank split at both
    ends by a 32-lane search, the two input windows, each thread's split
    at its first slot by a binary search in the windows, its serial
    merge, and the slots written back in input order."""
    a = np.asarray(a, U32)
    b = np.asarray(b, U32)
    na, nb = len(a), len(b)
    total = na + nb
    tile = threads * items
    first = (lambda x, y: x < y) if b_first else (lambda x, y: x <= y)
    out = np.full(total, -1, np.int64)
    d = np.minimum(np.arange(-(-total // tile) + 1) * tile, total)

    def before(p):  # a[p] goes before b[d - 1 - p]
        x = gather(a, p)
        return first(x, gather(b, d[:, None] - 1 - p)), x
    split, _, rounds = group_search(np.maximum(0, d - nb), np.minimum(d, na),
                                    before, 32)
    for t in range(len(d) - 1):
        d0, i0, i1 = int(d[t]), int(split[t]), int(split[t + 1])
        j0, j1 = d0 - i0, int(d[t + 1]) - i1
        wa, wb = a[i0:i1], b[j0:j1]
        la, lb = len(wa), len(wb)
        t0 = np.minimum(np.arange(threads) * items, la + lb)
        t1 = np.minimum(t0 + items, la + lb)
        lo, hi = np.maximum(0, t0 - lb), np.minimum(t0, la)
        while (lo < hi).any():
            mid = (lo + hi) >> 1
            act = lo < hi
            go = first(gather(wa, mid), gather(wb, t0 - 1 - mid))
            lo = np.where(act & go, mid + 1, lo)
            hi = np.where(act & ~go, mid, hi)
        ia, ib = lo, t0 - lo
        slot = np.full(la + lb, -1, np.int64)
        for k in range(items):
            live = t0 + k < t1
            take_a = live & ((ib >= lb) | ((ia < la) & first(
                gather(wa, ia), gather(wb, ib))))
            take_b = live & ~take_a
            slot[ia[take_a]] = d0 + t0[take_a] + k
            slot[la + ib[take_b]] = d0 + t0[take_b] + k
            ia = ia + take_a
            ib = ib + take_b
        out[i0:i1] = slot[:la]
        out[na + j0:na + j1] = slot[la:]
    assert (out >= 0).all()
    return out.astype(np.int32), rounds


def merge_runs(rng, na: int, nb: int, spread: int = 1 << 20):
    """Two sorted runs with duplicates within and across them."""
    a = np.sort(rng.integers(0, spread, na)).astype(U32)
    take = rng.integers(0, max(na, 1), nb // 2) if na else np.zeros(0, int)
    b = np.sort(np.r_[a[take], rng.integers(0, spread, nb - len(take))]
                ).astype(U32)
    return a, b


MERGE_SIZES = [(1, 1), (1, 31), (31, 1), (32, 33), (1023, 1025),
               (1024, 1024), (2047, 2049), (4096, 65536), (65536, 4096)]


@pytest.mark.parametrize("na,nb", MERGE_SIZES)
def test_merge_path_emulation_matches_jax(na, nb):
    rng = np.random.default_rng(na * 31 + nb)
    a, b = merge_runs(rng, na, nb, spread=max(8, (na + nb) // 4))
    got, rounds = merge_path_emulation(a, b)
    pa, pb = merge_ranks_ref(jnp.asarray(a), jnp.asarray(b))
    want = np.r_[np.asarray(pa), np.asarray(pb)]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, to_numpy(merge_positions_ref(to_device(a, "cpu"),
                                          to_device(b, "cpu")), np.int32))
    assert rounds.max() <= round_limit(min(na, nb) + 1, 32)
    if na + nb <= 4096:  # the per-side Pallas kernel, interpreted
        ra = np.asarray(merge_rank_pallas(tiles(a), b, leq=False,
                                          interpret=True)).reshape(-1)[:na]
        rb = np.asarray(merge_rank_pallas(tiles(b), a, leq=True,
                                          interpret=True)).reshape(-1)[:nb]
        np.testing.assert_array_equal(got, np.r_[np.arange(na) + ra,
                                                 np.arange(nb) + rb])


@pytest.mark.parametrize("case", ("equal", "disjoint-ab", "disjoint-ba",
                                  "edges", "empty-a", "empty-b",
                                  "small-tiles"))
def test_merge_path_emulation_adversarial(case):
    rng = np.random.default_rng(len(case))
    kw = {}
    if case == "equal":
        a, b = np.full(3000, 7, U32), np.full(5000, 7, U32)
    elif case == "disjoint-ab":
        a, b = np.arange(3000, dtype=U32), np.arange(5000, 9000, dtype=U32)
    elif case == "disjoint-ba":
        a, b = np.arange(5000, 9000, dtype=U32), np.arange(3000, dtype=U32)
    elif case == "edges":
        a, b = merge_runs(rng, 3001, 2999, spread=50)
        a = np.sort(np.r_[a, [0, 0xFFFFFFFE, 0xFFFFFFFE]]).astype(U32)
        b = np.sort(np.r_[b, [0, 0xFFFFFFFE]]).astype(U32)
    elif case == "empty-a":
        a, b = np.zeros(0, U32), np.arange(5000, dtype=U32)
    elif case == "empty-b":
        a, b = np.arange(5000, dtype=U32), np.zeros(0, U32)
    else:  # many ragged tiles of 4 threads x 3 slots
        a, b = merge_runs(rng, 997, 1003, spread=300)
        kw = dict(threads=4, items=3)
    got, _ = merge_path_emulation(a, b, **kw)
    pa, pb = merge_ranks_ref(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(got, np.r_[np.asarray(pa), np.asarray(pb)])
    assert sorted(got.tolist()) == list(range(len(a) + len(b)))


def test_merge_b_first_is_caught_on_cross_run_duplicates():
    """The fault chip_smoke.py plants in merge_path_sm90 (ties b-first)
    changes the slots of keys present in both runs, which the path's
    input holds."""
    a, b = CS.merge_inputs(np.random.default_rng(7), 1 << 12, 1 << 10)
    assert np.intersect1d(a, b).size > 0
    good, _ = merge_path_emulation(a, b)
    bad, _ = merge_path_emulation(a, b, b_first=True)
    assert (good != bad).any()
    assert sorted(bad.tolist()) == list(range(len(a) + len(b)))


def test_chip_smoke_merge_cases_cover_the_edges():
    """The sweep's adversarial runs: sorted, each u32 edge present, all
    keys equal, disjoint runs, a run of one, lengths off the tile; the
    emulation equals the plain version on the small ones."""
    cases = CS.merge_cases(np.random.default_rng(0), small=True)
    names = {name for name, _, _ in cases}
    assert {"equal", "disjoint", "one", "ragged", "u32-edges"} <= names
    for name, a, b in cases:
        assert (np.diff(a.astype(np.int64)) >= 0).all(), name
        assert (np.diff(b.astype(np.int64)) >= 0).all(), name
        got, _ = merge_path_emulation(a, b)
        want = merge_positions_ref(to_device(a, "cpu"), to_device(b, "cpu"))
        np.testing.assert_array_equal(got, to_numpy(want, np.int32), name)
    edges = next(np.r_[a, b] for n, a, b in cases if n == "u32-edges")
    assert {0, 0xFFFFFFFE} <= set(edges.tolist())
    assert any((len(a) + len(b)) % MERGE_TILE for _, a, b in cases)


# ------------------------------------------------- dispatch and hygiene
class _Recorder:
    def __init__(self, result):
        self.calls = 0
        self.result = result

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.result(*args)


def _meta(n):
    return torch.zeros(n, dtype=torch.int32, device="meta")


@pytest.mark.parametrize("n", (1, 1024, 8192))
def test_cascade_call_off_the_cpu_takes_cascade_sm90(monkeypatch, n):
    new = _Recorder(lambda *a: "sm90")
    monkeypatch.setattr(cascade_ops, "_launch_sm90", new)
    q = _meta(n)
    assert cascade_masks(q, q, q, q, object()) == "sm90"
    assert new.calls == 1


@pytest.mark.parametrize("na,nb", ((1, 1), (1 << 16, 1 << 19), (5, 0)))
def test_merge_ranks_off_the_cpu_take_one_merge_path_launch(monkeypatch,
                                                            na, nb):
    path = _Recorder(lambda a, b: merge_positions_ref(
        torch.arange(na, dtype=torch.int32), torch.arange(nb,
                                                          dtype=torch.int32)))
    rank = _Recorder(lambda *a: None)
    monkeypatch.setattr(merge_ops, "_launch_merge_path", path)
    monkeypatch.setattr(merge_ops, "_launch_rank", rank)
    pa, pb = merge_ranks(np.arange(na), np.arange(nb), "meta")
    assert (path.calls, rank.calls) == (1, 0)
    assert pa.dtype == pb.dtype == np.int64
    assert (len(pa), len(pb)) == (na, nb)
    assert merge_positions(_meta(3), _meta(4)) is not None
    assert (path.calls, rank.calls) == (2, 0)


def test_engine_merge_calls_are_one_merge_positions_each(monkeypatch):
    """The load's compaction rounds: each ``merge_ranks`` call of the
    executor is one ``merge_positions`` call, the count chip_smoke.py
    holds the ``merge_path_sm90`` launches to."""
    calls = []
    real = merge_ops.merge_positions
    monkeypatch.setattr(merge_ops, "merge_positions",
                        lambda a, b: calls.append(1) or real(a, b))
    eng = Engine(2, strategy="gloran",
                 config=EngineConfig(device="cpu", kernel_min_merge=1))
    rng = np.random.default_rng(0)
    for _ in range(6):
        k = rng.integers(0, 1 << 20, 4096).astype(np.uint64)
        eng.put_batch(k, k + np.uint64(1))
    merges = eng.kernel_counters.merge_calls
    eng.close()
    assert merges > 0 and len(calls) == merges


def _cascade_operands(dtype):
    q = torch.zeros(4, dtype=dtype)
    st = CascadeState(*(torch.zeros(2, dtype=dtype),) * 14, L=1, H=1, G=0)
    return q, st


@pytest.mark.parametrize("dtype,err", ((torch.int32, ValueError),
                                       (torch.float32, TypeError),
                                       (torch.int64, TypeError)))
def test_new_kernels_refuse_cpu_and_non_int32_operands(dtype, err):
    q, st = _cascade_operands(dtype)
    with pytest.raises(err, match="CUDA tensors" if err is ValueError
                       else "expected"):
        cascade_ops._launch_sm90(q, q, q, q, st)
    with pytest.raises(err, match="CUDA tensors" if err is ValueError
                       else "expected"):
        merge_ops._launch_merge_path(q, q)


def test_new_kernels_build_from_csrc(monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(ROOT / "no-such-toolkit"))
    monkeypatch.setattr(native, "_libs", {})
    for name in ("cascade_sm90", "merge_path_sm90"):
        assert name in native.KERNELS
        assert name in native.LAUNCHES
        src, lib = native._target(name)
        assert src == native.CSRC / f"{name}.cu" and src.exists()
        assert lib.parent == native.BUILD_DIR
        assert '#include "group_search.cuh"' in src.read_text()
        with pytest.raises(RuntimeError, match="nvcc not found"):
            native.library(name)
    assert (native.CSRC / "group_search.cuh").exists()
