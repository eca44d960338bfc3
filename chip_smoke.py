"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs a CUDA device, ``nvcc`` (``$CUDA_HOME``, default ``/usr/local/cuda``)
and this checkout; without them it exits non-zero before printing any
result.  Phases, each of which fails the run on any error:

1. Environment: the card's name and power limit, torch and CUDA
   versions, and the seconds the four kernels took to build (one nvcc
   per source, all started together).
2. The slice (the port's main path): an 8-shard hash-partitioned GLORAN
   ``Engine`` on ``cuda`` with the paper's default ``LSMConfig`` loads
   3 M uniform keys in [0, 2^28) with 1% range deletes (82 deletes of
   length 256 after every 8192-put batch), then answers 64 lookup
   batches of 8192 keys (half loaded, half uniform).  Results must
   equal a plain model of the op stream (last put wins; a range delete
   kills every older put it covers); every shard sub-batch must take
   one cascade launch covering G >= 1 GLORAN levels, and compactions
   must go through the merge-rank kernel.  Bottom-compaction GC leaves
   the DR-tree levels empty at the end of the load, so range deletes
   continue until every shard's index flushes a level again, and the
   lookups run once more against that state, the profiler reading the
   device's busy time over a few of them.
3. The per-level route: the same lookups with the cascade off (bloom
   and interval kernels) must return the same results.
4. Each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it (one shard's lookup sub-batch against
   the store's own pack, filter and DR-tree level; merge runs of 2^19
   and 2^16), bit-exact, with its median time, the plain version's
   time, its bound and, for merge-rank, ``torch.searchsorted`` as a
   yardstick.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
SECTOR = 32
UNIVERSE = 1 << 28
PUT_BATCH = 8192
RANGES_PER_BATCH = 82
RANGE_LEN = 256
LOOKUP_BATCHES = 64
LOOKUP_BATCH = 8192
KERNEL_SOURCES = {
    "cascade": ("src/repro_torch/csrc/cascade.cu",
                "src/repro/kernels/cascade/kernel.py:125"),
    "merge_rank": ("src/repro_torch/csrc/merge_rank.cu",
                   "src/repro/kernels/merge/kernel.py:53"),
    "bloom": ("src/repro_torch/csrc/bloom.cu",
              "src/repro/kernels/bloom/kernel.py:52"),
    "interval": ("src/repro_torch/csrc/interval.cu",
                 "src/repro/kernels/interval/kernel.py:61"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------ workload
def make_stream(seed: int, n_keys: int):
    """Put keys (value = key + 1) in batches, and after each batch its
    range deletes' low bounds."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, UNIVERSE, n_keys, dtype=np.uint64)
    n_batches = -(-n_keys // PUT_BATCH)
    los = rng.integers(0, UNIVERSE - RANGE_LEN,
                       (n_batches, RANGES_PER_BATCH), dtype=np.uint64)
    return keys, los


def make_lookups(seed: int, keys: np.ndarray, batches: int,
                 size: int) -> list[np.ndarray]:
    rng = np.random.default_rng(seed + 1)
    out = []
    for _ in range(batches):
        loaded = keys[rng.integers(0, len(keys), size // 2)]
        uniform = rng.integers(0, UNIVERSE, size - size // 2,
                               dtype=np.uint64)
        out.append(rng.permutation(np.concatenate([loaded, uniform])))
    return out


def model_lookup(keys: np.ndarray, los: np.ndarray, q: np.ndarray):
    """Plain model of the op stream: a key is live iff its last put came
    after every range delete covering it.  Put batch b precedes the
    range deletes issued after it, so a delete of batch b' kills a put
    of batch b iff b' >= b."""
    batch_of = np.arange(len(keys)) // PUT_BATCH
    order = np.argsort(keys, kind="stable")
    sk, sb = keys[order], batch_of[order]
    last = np.r_[sk[1:] != sk[:-1], True]
    uk, ub = sk[last], sb[last]
    j = np.minimum(np.searchsorted(uk, q), len(uk) - 1)
    put = uk[j] == q
    put_batch = np.where(put, ub[j], -1)
    flat = los.reshape(-1)
    rd_batch = np.repeat(np.arange(los.shape[0]), los.shape[1])
    o = np.argsort(flat, kind="stable")
    slo, sbatch = flat[o], rd_batch[o]
    qi = q.astype(np.int64)
    a = np.searchsorted(slo, np.maximum(qi - (RANGE_LEN - 1), 0)
                        .astype(np.uint64))
    b = np.searchsorted(slo, q, side="right")
    killed_by = np.full(len(q), -1)
    for i in np.flatnonzero(b > a):
        killed_by[i] = sbatch[a[i]:b[i]].max()
    found = put & (killed_by < put_batch)
    return found, np.where(found, q + np.uint64(1), np.uint64(0))


def load(eng, keys: np.ndarray, los: np.ndarray) -> float:
    t0 = time.perf_counter()
    for b in range(los.shape[0]):
        k = keys[b * PUT_BATCH:(b + 1) * PUT_BATCH]
        eng.put_batch(k, k + np.uint64(1))
        lo = los[b]
        eng.range_delete_batch(list(zip(lo.tolist(),
                                        (lo + RANGE_LEN).tolist())))
    return time.perf_counter() - t0


def lookups(eng, batches: list[np.ndarray]):
    results, lat = [], []
    for q in batches:
        t0 = time.perf_counter()
        found, vals = eng.get_batch(q)
        lat.append(time.perf_counter() - t0)
        results.append((found, vals))
    return results, lat


def check_results(results, batches, keys, los) -> None:
    for (found, vals), q in zip(results, batches):
        mf, mv = model_lookup(keys, los, q)
        # Values of keys not found are unspecified, as in the reference.
        wrong = (found != mf) | (found & (vals != mv))
        if wrong.any():
            bad = int(np.flatnonzero(wrong)[0])
            raise AssertionError(
                f"lookup of key {int(q[bad])}: engine ({found[bad]}, "
                f"{int(vals[bad])}) vs model ({mf[bad]}, {int(mv[bad])})")


# -------------------------------------------------------------- timing
def time_kernel_ms(fn, reps: int = 30) -> float:
    """Median device time of one launch: a sleep kernel holds the card
    while the host enqueues every launch between event pairs, so host
    overhead does not show as device time."""
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(50_000_000)
    for a, b in ev:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in ev)


def time_host_ms(fn, reps: int = 10) -> float:
    """Median wall time of a call that synchronizes with the host (the
    plain versions read metadata back), ending in a synchronize."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def max_abs_err(a, b) -> float:
    if isinstance(a, tuple):
        return max(max_abs_err(x, y) for x, y in zip(a, b))
    return float((a.to(b.dtype) - b).abs().max().item()) if a.numel() else 0.0


def search_sectors(cnt: int, n: int) -> int:
    """Distinct 32-byte sectors n binary searches over cnt sorted u32
    touch below the levels they share: about log2(cnt / n) each, the
    last three halvings falling in one sector."""
    return n * max(1, int(np.ceil(np.log2(max(cnt, 2) / max(n, 1)))) - 2)


def bloom_probe_counts(hash32, words, m_bits, seeds) -> int:
    """Word reads a Bloom probe that stops at its first unset bit makes
    over these queries."""
    from repro_torch.core.eve import mix32
    n = len(hash32)
    alive = np.ones(n, bool)
    reads = 0
    for s in seeds:
        reads += int(alive.sum())
        p = mix32(hash32, s) % np.uint32(m_bits)
        bit = (words[(p >> np.uint32(5)).astype(np.int64)]
               >> (p & np.uint32(31))) & np.uint32(1)
        alive &= bit == 1
    return reads


# -------------------------------------------------------------- phases
def environment() -> tuple[str, str]:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    return smi, torch.cuda.get_device_name(0)


def build_slice(n_keys: int, shards: int, seed: int, device: str):
    from repro_torch.core import GloranConfig, RAEConfig
    from repro_torch.engine import Engine, EngineConfig
    from repro_torch.lsm import LSMConfig
    keys, los = make_stream(seed, n_keys)
    eng = Engine(num_shards=shards, strategy="gloran",
                 lsm_config=LSMConfig(),
                 gloran_config=GloranConfig(
                     eve=RAEConfig(key_universe=UNIVERSE)),
                 config=EngineConfig(device=device))
    return eng, keys, los


def tail_deletes(eng, los: np.ndarray) -> np.ndarray:
    """Range deletes (82 a batch, no puts) until every shard's GLORAN
    index holds a DR-tree level with areas again; returns the low
    bounds of the whole stream."""
    tail = []
    while not all(len(l) for sh in eng.shards
                  for l in sh.tree.gloran.level_views()):
        assert len(tail) < 200, "index never flushed"
        lo = np.random.default_rng(1000 + len(tail)).integers(
            0, UNIVERSE - RANGE_LEN, RANGES_PER_BATCH, dtype=np.uint64)
        eng.range_delete_batch(list(zip(lo.tolist(),
                                        (lo + RANGE_LEN).tolist())))
        tail.append(lo)
    return np.concatenate([los, np.stack(tail)]) if tail else los


def report_lookups(tag, lat, card) -> None:
    total = sum(lat)
    ms = sorted(1e3 * x for x in lat)
    log(f"{tag}: {len(lat)} x {LOOKUP_BATCH} keys in {total:.3f} s = "
        f"{len(lat) * LOOKUP_BATCH / total:.1f} ops/s; batch p50 "
        f"{statistics.median(ms):.3f} ms, p99 "
        f"{ms[int(0.99 * (len(ms) - 1))]:.3f} ms {card}")


def check_cascade_path(eng, kc0, kc1, launches, shards) -> list:
    """Every shard sub-batch took exactly one cascade launch; returns
    the shards' cascade views."""
    sub_batches = LOOKUP_BATCHES * shards
    calls = kc1.cascade_calls - kc0.cascade_calls
    assert calls == sub_batches == launches, (calls, sub_batches, launches)
    views = [sh.registry.view(sh.tree) for sh in eng.shards]
    assert all(v is not None and v.state.G >= 1 for v in views), views
    return views


def device_busy(eng, batches) -> str:
    """Device time of the kernels over a few lookup batches, from the
    profiler, against the wall time of those batches."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        lookups(eng, batches)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0]
    if not events:
        return "device time not measured (the profiler saw no kernels)"
    busy = sum(e.device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.device_time_total)[:4]
    return (f"{len(batches)} batches: wall {wall_us:.1f} us, device busy "
            f"{busy:.1f} us ({100 * busy / wall_us:.3f}%); "
            + "; ".join(f"{e.key[:40]} {e.device_time_total:.1f} us / "
                        f"{e.count}" for e in top))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import native

    # 1. environment + build
    smi, kind = environment()
    card = f"[{smi}]"
    t0 = time.perf_counter()
    native.build_all()
    log(f"kernel build {time.perf_counter() - t0:.3f} s "
        f"({len(native.KERNELS)} sources)")

    # 2. the slice, cascade on: counts are zeroed just before the load
    # and read just after the lookups.
    shards = 8
    eng, keys, los = build_slice(3_000_000, shards, 0, "cuda")
    batches = make_lookups(0, keys, LOOKUP_BATCHES, LOOKUP_BATCH)
    torch.cuda.reset_peak_memory_stats()
    native.reset_launches()
    load_s = load(eng, keys, los)
    load_launches = dict(native.LAUNCHES)
    kc0 = eng.kernel_counters
    results, lat = lookups(eng, batches)
    main_launches = dict(native.LAUNCHES)
    kc1 = eng.kernel_counters
    n_ops = len(keys) + los.size
    log(f"load: {len(keys)} puts + {los.size} range deletes "
        f"({100 * los.size / n_ops:.3f}% range deletes) in {load_s:.3f} s "
        f"= {n_ops / load_s:.1f} ops/s; launches "
        f"{json.dumps(load_launches)} {card}")
    report_lookups("lookups", lat, card)
    check_results(results, batches, keys, los)
    log(f"results equal the model on {LOOKUP_BATCHES * LOOKUP_BATCH} "
        f"lookups ({sum(int(f.sum()) for f, _ in results)} found)")
    views = check_cascade_path(
        eng, kc0, kc1, main_launches["cascade"] - load_launches["cascade"],
        shards)
    assert kc1.merge_calls > 0 and main_launches["merge_rank"] > 0, kc1
    log(f"kernel counters: {json.dumps(kc1.snapshot())}")
    log(f"cascade L per shard {[v.state.L for v in views]}, G per shard "
        f"{[v.state.G for v in views]}, level entries "
        f"{[v.state.key_cnt.tolist() for v in views]}, GLORAN areas "
        f"{[v.state.gl_cnt.tolist() for v in views]}")
    log(f"device memory: max allocated "
        f"{torch.cuda.max_memory_allocated()} B, uploads "
        f"{kc1.upload_bytes} B, packs "
        f"{sum(v.state.nbytes for v in views)} B {card}")

    # Bottom-compaction GC empties the DR-tree levels during the load;
    # range deletes continue (82 a batch, no puts) until every shard's
    # index has flushed a level again, and the lookups run once more
    # with the cascade's GLORAN stage over real areas.
    los_all = tail_deletes(eng, los)
    kc2 = eng.kernel_counters
    native.reset_launches()
    results, lat = lookups(eng, batches)
    main2 = dict(native.LAUNCHES)
    kc3 = eng.kernel_counters
    report_lookups(f"lookups after {los_all.size - los.size} more range "
                   "deletes", lat, card)
    check_results(results, batches, keys, los_all)
    views = check_cascade_path(eng, kc2, kc3, main2["cascade"], shards)
    areas = [v.state.gl_cnt.tolist() for v in views]
    assert all(sum(a) > 0 for a in areas), areas
    main_launches["cascade"] += main2["cascade"]
    log(f"results equal the model; GLORAN areas per shard {areas}; "
        f"cascade launches {main2['cascade']}")
    log(device_busy(eng, batches[:4]))

    # 3. the per-level route on the same store: cascade off, and every
    # probe of a level takes a kernel.  The default gates would keep the
    # interval kernel off: GLORAN validity probes reach only the few
    # EVE-positive keys of a sub-batch.
    eng.config.use_cascade_kernel = False
    eng.config.kernel_min_batch = 1
    eng.config.kernel_min_areas = 1
    eng.config.kernel_min_filter = 1
    kc3 = eng.kernel_counters
    native.reset_launches()
    results2, lat2 = lookups(eng, batches)
    route_launches = dict(native.LAUNCHES)
    kc4 = eng.kernel_counters
    for (f0, v0), (f1, v1) in zip(results, results2):
        assert np.array_equal(f0, f1) and np.array_equal(v0, v1)
    assert kc4.cascade_calls == kc3.cascade_calls
    assert kc4.bloom_calls > kc3.bloom_calls, kc4
    assert kc4.interval_calls > kc3.interval_calls, kc4
    assert route_launches["bloom"] > 0 and route_launches["interval"] > 0
    report_lookups("per-level route (results equal)", lat2, card)
    log(f"per-level launches {json.dumps(route_launches)}")

    # 4. each kernel against its plain version at the path's shapes
    records = kernel_checks(eng, views, main_launches,
                            route_launches, card)
    eng.close()
    log(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


def kernel_checks(eng, views, main_launches, route_launches,
                  card) -> list[dict]:
    from repro_torch.core.eve import fold64to32
    from repro_torch.kernels.bloom.ops import bloom_probe
    from repro_torch.kernels.bloom.ref import bloom_probe_ref
    from repro_torch.kernels.cascade.ops import cascade_masks
    from repro_torch.kernels.cascade.ref import cascade_ref
    from repro_torch.kernels.interval.ops import interval_query
    from repro_torch.kernels.interval.ref import interval_query_ref
    from repro_torch.kernels.merge.ops import merge_rank
    from repro_torch.kernels.merge.ref import merge_rank_ref
    from repro_torch.kernels.u32 import to_device, widen

    dev = eng.device
    rng = np.random.default_rng(7)
    sh = eng.shards[0]
    tree = sh.tree
    n = LOOKUP_BATCH // len(eng.shards)  # one shard's sub-batch
    qk = np.sort(rng.integers(0, UNIVERSE, n, dtype=np.uint64))
    qk[:n // 2] = tree.levels[-1].keys[rng.integers(
        0, len(tree.levels[-1]), n // 2)]
    qk[0], qk[1] = 0, 0xFFFFFFFE
    qh = fold64to32(qk)
    records = []

    def record(name, launches, kernel, plain, bytes_, library=None):
        # The counts of the main-path windows were read already; the
        # comparisons below launch outside them.
        got = kernel()
        torch.cuda.synchronize()
        want = plain()
        err = max_abs_err(got, want)
        if err != 0.0:
            raise AssertionError(f"{name}: kernel differs from plain "
                                 f"version (max abs err {err})")
        ms = time_kernel_ms(kernel)
        plain_ms = time_host_ms(plain)
        lib_ms = time_kernel_ms(library) if library else None
        bound = bytes_ / HBM_BYTES_PER_S * 1e3
        src, replaces = KERNEL_SOURCES[name]
        log(f"{name}: bit-exact; {ms:.6f} ms (plain {plain_ms:.6f} ms, "
            f"library {lib_ms}, bound {bound:.6f} ms from {bytes_} B) "
            f"{card}")
        records.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches,
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound, "bound_by": "bytes",
                        "library_ms": lib_ms})

    # cascade: shard 0's pack, one shard's lookup sub-batch
    st = views[0].state
    q = (to_device(qk, dev), to_device(qh, dev),
         to_device(np.zeros(n), dev), to_device(np.zeros(n), dev, np.int32))
    cnt = st.key_cnt.tolist()
    probes = sum(bloom_probe_counts(
        qh, lvl.bloom.words, lvl.bloom.m_bits, lvl.bloom.seeds)
        for lvl in tree.levels if lvl is not None and len(lvl))
    gl_cnt = st.gl_cnt.tolist()
    sectors = (probes + sum(min(search_sectors(c, n) + n, c // 8 + 1)
                            for c in cnt)
               + sum(min(search_sectors(c, n), c // 8 + 1) + 3 * n
                     for c in gl_cnt))
    record("cascade", main_launches["cascade"],
           lambda: cascade_masks(*q, st), lambda: cascade_ref(*q, st),
           16 * n + (12 + 4 * st.L) * n + SECTOR * sectors)

    # merge rank: runs of 2^19 and 2^16, ties and the u32 edge included
    ka = np.sort(rng.integers(0, UNIVERSE, 1 << 19, dtype=np.uint64))
    kb = np.sort(np.concatenate([
        ka[rng.integers(0, len(ka), 1 << 15)],
        rng.integers(0, UNIVERSE, (1 << 15) - 1, dtype=np.uint64),
        np.array([0xFFFFFFFE], np.uint64)]))
    a32, b32 = to_device(ka, dev), to_device(kb, dev)
    a64, b64 = widen(a32), widen(b32)
    record("merge_rank", main_launches["merge_rank"],
           lambda: (merge_rank(a32, b32, leq=False),
                    merge_rank(b32, a32, leq=True)),
           lambda: (merge_rank_ref(a32, b32, leq=False),
                    merge_rank_ref(b32, a32, leq=True)),
           8 * (len(ka) + len(kb)),
           library=lambda: (torch.searchsorted(b64, a64),
                            torch.searchsorted(a64, b64, right=True)))

    # bloom: the deepest level's filter (~400 K entries)
    lvl = tree.levels[-1]
    bb = lvl.bloom
    words = sh.registry.bloom_words(lvl)
    kq = to_device(qh, dev)
    record("bloom", route_launches["bloom"],
           lambda: bloom_probe(kq, words, m_bits=bb.m_bits, seeds=bb.seeds),
           lambda: bloom_probe_ref(kq, words, m_bits=bb.m_bits,
                                   seeds=bb.seeds),
           8 * n + SECTOR * bloom_probe_counts(qh, bb.words, bb.m_bits,
                                               bb.seeds))

    # interval: shard 0's DR-tree level, keys with seqs
    live = tree.gloran.level_views()
    g = max(live, key=len)
    lo, hi, smin, smax = sh.registry.gl_columns(g, live)
    gk = qk.copy()
    gk[:n // 4] = g.areas.lo[rng.integers(0, len(g.areas), n // 4)]
    sq = rng.integers(0, tree.seq, n, dtype=np.uint64)
    ik, isq = to_device(gk, dev), to_device(sq, dev)
    record("interval", route_launches["interval"],
           lambda: interval_query(ik, isq, lo, hi, smin, smax),
           lambda: interval_query_ref(ik, isq, lo, hi, smin, smax),
           12 * n + SECTOR * (min(search_sectors(len(g.areas), n),
                                  len(g.areas) // 8 + 1) + 3 * n))
    return records


if __name__ == "__main__":
    sys.exit(main())
