"""The bloom and interval Hopper kernels, rehearsed on the CPU.

``csrc/bloom_sm90.cu`` and ``csrc/interval_sm90.cu`` run only on an
H100; ``chip_smoke.py`` holds them bit-exact to their plain versions
there.  What the
CPU can check is checked here, with numpy emulations laid out as the
kernels work:

- the reciprocal modulo (``mod_by``): ``x - umulhi(x, magic) * d`` with
  ``magic = floor((2^32 - 1) / d)`` and one correction step equals
  ``x % d`` for every u32 x and d in [1, 2^32);
- ``bloom_sm90``, a thread a key: every position first, all H loads,
  then the AND;
- ``interval_sm90``, a thread a query: the shared-memory directory of
  at most 256 entries of ``lo`` (whole or every 2^s-th), then the
  segment in global memory, then the three tail tests without the
  short-circuit;
- each against the JAX package's Pallas kernel in interpret mode and the
  port's plain version, on the edge cases ``chip_smoke.py`` sweeps on the
  card;
- that the faults ``chip_smoke.py`` plants (H - 1 seeds, lower_bound)
  change the answer on these inputs;
- the wrappers' dispatch, operand checks and build from ``csrc/``.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.eve import BloomBits as JBloomBits
from repro.core.eve import fold64to32 as jfold
from repro.kernels.bloom.kernel import bloom_probe_pallas
from repro.kernels.interval.ops import interval_query as jinterval_query
from repro_torch.core.eve import mix32
from repro_torch.engine import Engine, EngineConfig
from repro_torch.kernels import native
from repro_torch.kernels.bloom import bloom_probe, bloom_probe_ref
from repro_torch.kernels.bloom import ops as bloom_ops
from repro_torch.kernels.interval import interval_query, interval_query_ref
from repro_torch.kernels.interval import ops as interval_ops
from repro_torch.kernels.u32 import to_device, to_numpy

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # the seeded sweep below stands in
    given = None

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
LANES = 128
TILE_ROWS = 8 * LANES
U32 = np.uint32
M32 = (1 << 32) - 1
DIR_ENTRIES = 256  # kDirEntries in csrc/interval_sm90.cu


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# The sweep's cases.
CS = _load("chip_smoke", ROOT / "chip_smoke.py")
BLOOM_CASES = CS.bloom_cases(np.random.default_rng(17))
INTERVAL_CASES = CS.interval_cases(np.random.default_rng(18))


def tiles(a: np.ndarray) -> np.ndarray:
    out = np.zeros(max(1, -(-len(a) // TILE_ROWS)) * TILE_ROWS, U32)
    out[:len(a)] = a
    return out.reshape(-1, LANES)


def t32(a) -> torch.Tensor:
    return to_device(a, "cpu")


def np32(t: torch.Tensor) -> np.ndarray:
    return to_numpy(t, np.int32)


# -------------------------------------------------- reciprocal modulo
def mod_by(x, d):
    """``bloom_sm90.cu::mod_by`` in u32 arithmetic (numpy uint64 holds
    each u32 product's full 64 bits): returns (x mod d, the remainder
    before the correction step)."""
    x = np.asarray(x, np.uint64)
    d = np.asarray(d, np.uint64)
    magic = np.uint64(M32) // d
    q = (x * magic) >> np.uint64(32)  # __umulhi
    r = (x - ((q * d) & np.uint64(M32))) & np.uint64(M32)
    return np.where(r >= d, r - d, r), r


def _check_mod(x, d):
    got, before = mod_by(x, d)
    x = np.asarray(x, np.uint64)
    d = np.asarray(d, np.uint64)
    np.testing.assert_array_equal(got, x % d)
    # The quotient estimate is floor(x / d) or one less.
    assert (before < 2 * d).all()


if given is not None:
    @settings(max_examples=3000, deadline=None)
    @given(st.integers(0, M32), st.integers(1, M32))
    def test_reciprocal_modulo_equals_remainder(x, d):
        _check_mod([x], [d])
else:
    def test_reciprocal_modulo_equals_remainder():
        rng = np.random.default_rng(0)
        _check_mod(rng.integers(0, 1 << 32, 200_000, dtype=np.uint64),
                   rng.integers(1, 1 << 32, 200_000, dtype=np.uint64))


EXTREME_D = (1, 2, 3, 31, 32, 64, 12_280, 70_001, 30_000_000, (1 << 31) - 1,
             1 << 31, (1 << 31) + 1, M32 - 1, M32)


@pytest.mark.parametrize("d", EXTREME_D)
def test_reciprocal_modulo_extremes(d):
    """Pinned: x at 0, 1, around every multiple of d near both ends and
    at the top of u32, and a seeded sweep of x, for the extreme d."""
    rng = np.random.default_rng(d & 0xFFFF)
    ks = np.r_[0, 1, 2, M32 // d - 1, M32 // d, rng.integers(
        0, M32 // d + 1, 64)].astype(np.uint64)
    x = (ks[:, None] * np.uint64(d) + np.array([0, 1], np.uint64))
    x = np.r_[x.ravel(), np.uint64(d) - np.uint64(1), 0, 1, M32, M32 - 1,
              rng.integers(0, 1 << 32, 20_000, dtype=np.uint64)]
    x = x[x <= M32]
    _check_mod(x, np.full(len(x), d, np.uint64))


def test_reciprocal_modulo_random_pairs():
    rng = np.random.default_rng(1)
    x = rng.integers(0, 1 << 32, 1_000_000, dtype=np.uint64)
    d = np.r_[rng.integers(1, 1 << 32, 500_000, dtype=np.uint64),
              rng.integers(1, 1 << 16, 500_000, dtype=np.uint64)]
    _check_mod(x, d)


# ---------------------------------------------- bloom_sm90, emulated
def bloom_sm90_emulation(keys32, words, m_bits, seeds, *,
                         fault: bool = False):
    """``bloom_sm90`` on host arrays: all H positions of a key by
    ``mod_by``, all H word loads, then the AND (H = 0: every key may be
    present)."""
    k = np.asarray(keys32, U32)
    words = np.asarray(words, U32)
    seeds = np.asarray(seeds, U32)
    if fault and len(seeds):
        seeds = seeds[:-1]
    if not len(seeds):
        return np.ones(len(k), np.int32)
    p, _ = mod_by(mix32(np.broadcast_to(k[:, None], (len(k), len(seeds))),
                        seeds[None, :]), m_bits)
    w = words[(p >> np.uint64(5)).astype(np.int64)]
    bits = (w >> (p & np.uint64(31))) & np.uint64(1)
    return bits.all(1).astype(np.int32)


def bloom_pallas(keys32, words, m_bits, seeds):
    return np.asarray(bloom_probe_pallas(
        tiles(keys32), np.asarray(words, U32), m_bits=int(m_bits),
        seeds=tuple(int(s) for s in seeds),
        interpret=True)).reshape(-1)[:len(keys32)]


@pytest.mark.parametrize("case", [c[0] for c in BLOOM_CASES])
def test_bloom_sm90_emulation_matches_pallas_and_plain(case):
    _, k, w, m_bits, seeds = next(c for c in BLOOM_CASES if c[0] == case)
    want = bloom_pallas(k, w, m_bits, seeds)
    plain = np32(bloom_probe_ref(t32(k), t32(w), m_bits=m_bits, seeds=seeds))
    np.testing.assert_array_equal(plain, want)
    np.testing.assert_array_equal(bloom_sm90_emulation(k, w, m_bits, seeds),
                                  want)


@pytest.mark.parametrize("hashes", (1, 6, 9))
def test_bloom_sm90_emulation_matches_the_filter(hashes):
    """A filter of 10 bits a key (the paper's 6 hashes, one, and past
    the launcher's H <= 8 templates) over 20 K keys: no false negative,
    and the JAX filter's own verdicts."""
    rng = np.random.default_rng(5)
    items = rng.integers(0, 1 << 62, 20_000, dtype=np.uint64)
    bb = JBloomBits(10 * len(items), hashes, seed=9)
    bb.insert(items)
    keys = np.r_[items[:2000], rng.integers(0, 1 << 62, 2000,
                                            dtype=np.uint64)]
    got = bloom_sm90_emulation(jfold(keys), bb.words, bb.m_bits, bb.seeds)
    np.testing.assert_array_equal(got.astype(bool), bb.might_contain(keys))
    assert got[:2000].all()
    np.testing.assert_array_equal(got, bloom_pallas(jfold(keys), bb.words,
                                                    bb.m_bits, bb.seeds))


@pytest.mark.parametrize("seed", (3, 4))
def test_bloom_h_minus_one_is_caught_on_absent_keys(seed):
    rng = np.random.default_rng(6)
    items = rng.integers(0, 1 << 62, 30_000, dtype=np.uint64)
    bb = JBloomBits(10 * len(items), 6, seed=seed)
    bb.insert(items)
    absent = jfold(rng.integers(0, 1 << 62, 8192, dtype=np.uint64))
    want = bloom_sm90_emulation(absent, bb.words, bb.m_bits, bb.seeds)
    wrong = bloom_sm90_emulation(absent, bb.words, bb.m_bits, bb.seeds,
                                 fault=True)
    assert (wrong != want).sum() > 0 and (wrong >= want).all()


# ------------------------------------------- interval_sm90, emulated
def bisect(a, lo, hi, q, *, lower: bool):
    """The kernels' binary search loop, all queries at once: the first
    index of [lo, hi) whose element is not before q."""
    lo, hi = lo.astype(np.int64).copy(), hi.astype(np.int64).copy()
    q = q.astype(np.uint64)
    while (act := lo < hi).any():
        mid = (lo + hi) >> 1
        x = a[np.clip(mid, 0, max(len(a) - 1, 0))].astype(np.uint64) \
            if len(a) else np.zeros(len(q), np.uint64)
        go = (x < q) if lower else (x <= q)
        lo = np.where(act & go, mid + 1, lo)
        hi = np.where(act & ~go, mid, hi)
    return lo


def dir_shift(m: int, entries: int = DIR_ENTRIES) -> int:
    shift = 0
    while -(-m // (1 << shift)) > entries:
        shift += 1
    return shift


def tail(j, k, s, hi, smin, smax):
    """The three tail tests at idx j, issued together."""
    jc = np.maximum(j, 0)
    if not len(hi):
        return np.zeros(len(k), np.int32)
    return ((j >= 0) & (k < hi[jc]) & (smin[jc] <= s)
            & (s < smax[jc])).astype(np.int32)


def interval_sm90_emulation(k, s, lo, hi, smin, smax, *,
                            lower: bool = False):
    """The directory dir[t] = lo[t << shift], t < T <= 256, searched in
    shared memory; then, when strided, the 2^shift-entry segment between
    two directory entries in global memory; then the tail tests."""
    k, s = (np.asarray(x, U32).astype(np.uint64) for x in (k, s))
    m = len(lo)
    shift = dir_shift(m)
    T = -(-m // (1 << shift))
    d = np.asarray(lo, U32)[::1 << shift][:T]
    assert len(d) == T <= DIR_ENTRIES
    n = len(k)
    a = bisect(d, np.zeros(n), np.full(n, T), k, lower=lower)
    ans = a.copy()
    if shift:
        seg = a > 0
        lo_i = np.where(seg, ((a - 1) << shift) + 1, 0)
        hi_i = np.where(seg, np.minimum(a << shift, m), 0)
        ans = np.where(seg, bisect(np.asarray(lo, U32), lo_i, hi_i, k,
                                   lower=lower), a)
    return tail(ans - 1, k, s, *(np.asarray(c, U32).astype(np.uint64)
                                for c in (hi, smin, smax)))


def interval_jax(k, s, lo, hi, smin, smax):
    return np.asarray(jinterval_query(
        np.asarray(k, U32), np.asarray(s, U32), *(np.asarray(c, U32)
                                                  for c in (lo, hi, smin, smax)),
        interpret=True)).astype(np.int32)


@pytest.mark.parametrize("case", [c[0] for c in INTERVAL_CASES])
def test_interval_sm90_emulation_matches_pallas_and_plain(case):
    _, k, s, *cols = next(c for c in INTERVAL_CASES if c[0] == case)
    want = interval_jax(k, s, *cols)
    plain = np32(interval_query_ref(t32(k), t32(s), *map(t32, cols)))
    np.testing.assert_array_equal(plain, want)
    np.testing.assert_array_equal(interval_sm90_emulation(k, s, *cols), want)


@pytest.mark.parametrize("m", (1, 64, 255, 256, 257, 512, 513, 8192, 8193,
                               1 << 15, (1 << 16) + 3))
def test_interval_designs_on_registry_levels(m):
    """Levels staged whole (m <= 256) and strided (shift 1 to 9, across
    each boundary of the directory's size), keys at lo, at hi - 1 and at
    hi, seqs at smin and smax."""
    rng = np.random.default_rng(m)
    cols = CS.disjoint_level(rng, m, max(64, 1 << (m - 1).bit_length()))
    k, s = CS.stab_queries(rng, cols, 1500)
    want = np32(interval_query_ref(t32(k), t32(s), *map(t32, cols)))
    assert 0 < want.sum() < len(want)
    np.testing.assert_array_equal(interval_sm90_emulation(k, s, *cols), want)


@pytest.mark.parametrize("m,pad", ((200, 256), (8000, 8192), (9000, 16384)))
def test_interval_lower_bound_is_caught_at_area_starts(m, pad):
    rng = np.random.default_rng(11)
    cols = CS.disjoint_level(rng, m, pad)
    a = rng.integers(0, m, 1024)
    k, s = cols[0][a], cols[2][a]  # at the area's start, seq at smin
    want = interval_sm90_emulation(k, s, *cols)
    wrong = interval_sm90_emulation(k, s, *cols, lower=True)
    assert want.sum() > 0 and not (wrong & want).any()


def test_chip_smoke_filter_cases_cover_the_edges():
    """The card's sweep: n = 1 and ragged n, H = 0, 9 and 32, bit counts
    off a multiple of 32, keys 0 and 0xFFFFFFFE; an empty level, one
    area probed at lo and hi with seqs at smin and smax, the registry's
    pow2 padding, strided directories."""
    b = {name: (k, w, m, s) for name, k, w, m, s in BLOOM_CASES}
    assert {len(s) for _, _, s in ((k, m, s) for k, _, m, s in b.values())} \
        >= {0, 6, 9, 32}
    assert any(m % 32 for _, _, m, _ in b.values())
    lens = {len(k) for k, _, _, _ in b.values()}
    assert 1 in lens and any(n % 4 for n in lens)
    edges = np.concatenate([k for k, _, _, _ in b.values()])
    assert {0, 0xFFFFFFFE} <= set(edges.tolist())
    cases = {c[0]: c[1:] for c in INTERVAL_CASES}
    assert len(cases["empty level"][2]) == 0
    k, s, lo, hi, smin, smax = cases["one area"]
    assert len(lo) == 1
    assert {int(lo[0]), int(hi[0])} <= set(k.tolist())
    assert {int(smin[0]), int(smax[0])} <= set(s.tolist())
    pad = cases["pow2-padded, clamped"]
    assert len(pad[2]) == 64 and pad[2][-1] == 0xFFFFFFFF == pad[3][-1]
    assert pad[4][-1] == 0 == pad[5][-1]
    shifts = {dir_shift(len(c[2])) for c in cases.values()}
    assert 0 in shifts and len(shifts) > 2
    assert any(len(c[0]) == 1 for c in cases.values())
    assert {0, 0xFFFFFFFE} <= set(np.concatenate(
        [c[0] for c in cases.values()]).tolist())


# ------------------------------------------------- dispatch and hygiene
class _Recorder:
    def __init__(self, result):
        self.calls = []
        self.result = result

    def __call__(self, *args, **kwargs):
        self.calls.append(kwargs)
        return self.result


def _meta(n):
    return torch.zeros(n, dtype=torch.int32, device="meta")


@pytest.mark.parametrize("n", (1, 1024, 8192))
def test_bloom_call_off_the_cpu_takes_bloom_sm90(monkeypatch, n):
    new = _Recorder("sm90")
    monkeypatch.setattr(bloom_ops, "_launch_sm90", new)
    assert bloom_probe(_meta(n), _meta(64), m_bits=2048,
                       seeds=(1, 2)) == "sm90"
    assert new.calls == [{}]


@pytest.mark.parametrize("n,m", ((1, 64), (1024, 8192), (8192, 8192),
                                 (1024, 1 << 20), (8192, 1 << 20)))
def test_interval_call_off_the_cpu_takes_interval_sm90(monkeypatch, n, m):
    new = _Recorder("sm90")
    monkeypatch.setattr(interval_ops, "_launch_sm90", new)
    cols = (_meta(m),) * 4
    assert interval_query(_meta(n), _meta(n), *cols) == "sm90"
    assert new.calls == [{}]


def test_engine_per_level_route_calls_the_public_wrappers(monkeypatch):
    """With the cascade off, every gated probe of the executor goes
    through ``bloom_probe`` and ``interval_query``, the calls whose CUDA
    launches chip_smoke.py holds to ``KernelCounters``."""
    from repro_torch.engine import executor
    seen = {"bloom": 0, "interval": 0}
    real_b, real_i = executor.bloom_probe, executor.interval_query

    def spy_b(*a, **kw):
        seen["bloom"] += 1
        return real_b(*a, **kw)

    def spy_i(*a):
        seen["interval"] += 1
        return real_i(*a)

    monkeypatch.setattr(executor, "bloom_probe", spy_b)
    monkeypatch.setattr(executor, "interval_query", spy_i)
    eng = Engine(2, strategy="gloran", config=EngineConfig(
        device="cpu", use_cascade_kernel=False, kernel_min_batch=1,
        kernel_min_areas=1, kernel_min_filter=1))
    rng = np.random.default_rng(0)
    for _ in range(6):
        k = rng.integers(0, 1 << 20, 4096).astype(np.uint64)
        eng.put_batch(k, k + np.uint64(1))
        lo = rng.integers(0, 1 << 20, 600).astype(np.uint64)
        eng.range_delete_batch(list(zip(lo.tolist(), (lo + 16).tolist())))
    eng.get_batch(rng.integers(0, 1 << 20, 4096).astype(np.uint64))
    kc = eng.kernel_counters
    eng.close()
    assert seen == {"bloom": kc.bloom_calls, "interval": kc.interval_calls}
    assert kc.bloom_calls > 0


def _bloom_operands(dtype):
    return torch.zeros(4, dtype=dtype), torch.zeros(8, dtype=dtype)


@pytest.mark.parametrize("dtype,err", ((torch.int32, ValueError),
                                       (torch.float32, TypeError),
                                       (torch.int64, TypeError)))
def test_filter_kernels_refuse_cpu_and_non_int32_operands(dtype, err):
    k, w = _bloom_operands(dtype)
    match = "CUDA tensors" if err is ValueError else "expected"
    with pytest.raises(err, match=match):
        bloom_ops._launch_sm90(k, w, 100, (1, 2))
    cols = (torch.zeros(64, dtype=dtype),) * 4
    with pytest.raises(err, match=match):
        interval_ops._launch_sm90(k, k, *cols)


def test_filter_kernels_refuse_bad_shapes():
    k, w = _bloom_operands(torch.int32)
    for m_bits in (0, 8 * 32 + 1, 1 << 32):
        with pytest.raises(ValueError, match="m_bits"):
            bloom_ops._launch_sm90(k, w, m_bits, (1,))
    cols = (torch.zeros(64, dtype=torch.int32),) * 3
    with pytest.raises(ValueError, match="areas"):
        interval_ops._launch_sm90(k, k, torch.zeros(63, dtype=torch.int32),
                                  *cols)
    with pytest.raises(ValueError, match="seqs"):
        interval_ops._launch_sm90(k, k[:3], *(cols + cols[:1]))


def test_filter_kernels_build_from_csrc(monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(ROOT / "no-such-toolkit"))
    monkeypatch.setattr(native, "_libs", {})
    for name in ("bloom_sm90", "interval_sm90"):
        assert name in native.KERNELS and name in native.LAUNCHES
        src, lib = native._target(name)
        assert src == native.CSRC / f"{name}.cu" and src.exists()
        assert lib.parent == native.BUILD_DIR
        assert '#include "common.cuh"' in src.read_text()
        with pytest.raises(RuntimeError, match="nvcc not found"):
            native.library(name)
    # One kernel a store function: the first kernels are out of the
    # build and out of the sources.
    for name in ("bloom", "interval"):
        assert name not in native.KERNELS and name not in native.LAUNCHES
        assert not (native.CSRC / f"{name}.cu").exists()
    assert "kMaxSeeds = 32" in (native.CSRC / "bloom_sm90.cu").read_text()
    assert f"kDirEntries = {DIR_ENTRIES}" in (
        native.CSRC / "interval_sm90.cu").read_text()
