"""Shared cells of the engine parity suites: ``repro_torch.engine.Engine``
on the CPU against ``repro.engine.Engine``.

The same op stream, made with numpy from a seed, drives both engines at
a small size (buffer 512, T = 4, GLORAN index buffer 512) where levels,
compactions through the merge-rank hook and GLORAN DR-tree levels all
occur.  Found masks and values, every shard's ``IOStats`` snapshot, the
kernel call and query counts and the total upload bytes must be equal,
in every cell.  Integers are compared exactly.
"""

import numpy as np

from repro.core import GloranConfig as JGloranConfig
from repro.core import LSMDRTreeConfig as JIndexConfig
from repro.core import RAEConfig as JRAEConfig
from repro.engine import Engine as JEngine
from repro.engine import EngineConfig as JEngineConfig
from repro.lsm import LSMConfig as JLSMConfig
from repro_torch.core import GloranConfig, LSMDRTreeConfig, RAEConfig
from repro_torch.engine import Engine, EngineConfig
from repro_torch.lsm import LSMConfig

UNIVERSE = 1 << 20
KEYS = 60_000
COUNTED = ("interval_calls", "interval_queries", "bloom_calls",
           "bloom_queries", "merge_calls", "merge_keys", "cascade_calls",
           "cascade_queries", "cascade_packs", "upload_bytes")


def _configs(torch_side: bool, strategy: str):
    L, G, D, R = ((LSMConfig, GloranConfig, LSMDRTreeConfig, RAEConfig)
                  if torch_side else
                  (JLSMConfig, JGloranConfig, JIndexConfig, JRAEConfig))
    lsm = L(buffer_capacity=512, size_ratio=4, key_size=16, value_size=48,
            block_size=512, key_universe=UNIVERSE)
    gl = (G(index=D(buffer_capacity=512, size_ratio=4, key_size=16,
                    block_size=512),
            eve=R(capacity=4096, key_universe=UNIVERSE))
          if strategy == "gloran" else None)
    return lsm, gl


def build(torch_side: bool, strategy: str, shards: int, cascade: bool,
          pipeline: bool, **extra):
    """One engine of a cell; ``extra`` sets more ``EngineConfig`` fields
    on both sides (``partition``, ``scheduler``, gates)."""
    lsm, gl = _configs(torch_side, strategy)
    kw = {"cache_blocks": 64, "use_cascade_kernel": cascade,
          "pipeline": pipeline, **extra}
    if torch_side:
        cfg, cls = EngineConfig(device="cpu", **kw), Engine
    else:
        cfg = JEngineConfig(**{"procs": 0, "devices": 0,
                               "scheduler": False, **kw})
        cls = JEngine
    return cls(num_shards=shards, strategy=strategy, lsm_config=lsm,
               gloran_config=gl, config=cfg)


def drive(eng, seed: int = 0) -> list:
    """Puts, point deletes and range deletes, with a lookup batch of
    loaded and uniform keys after every round."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(4):
        k = rng.integers(0, KEYS, 1500).astype(np.uint64)
        eng.put_batch(k, k * np.uint64(3) + np.uint64(1))
        eng.delete_batch(rng.integers(0, KEYS, 100).astype(np.uint64))
        lo = rng.integers(0, KEYS - 64, 150)
        width = rng.integers(1, 16, 150)
        eng.range_delete_batch([(int(a), int(a + w))
                                for a, w in zip(lo, width)])
        q = np.concatenate([k[:600],
                            rng.integers(0, KEYS, 600).astype(np.uint64)])
        found, vals = eng.get_batch(q)
        out.append((found.copy(), vals.copy()))
    return out


def observe(eng) -> dict:
    kc = eng.kernel_counters.snapshot()
    eng.close()
    return {"io": [sh.tree.io.snapshot() for sh in eng.shards],
            "levels": [[len(l) if l is not None else 0
                        for l in sh.tree.levels] for sh in eng.shards],
            "kernels": {k: kc[k] for k in COUNTED}}


_REFERENCE: dict = {}


def reference(strategy: str, shards: int, cascade: bool):
    """The JAX engine's run of a cell (its pipelined and serial modes
    are byte-identical, which its own suite checks)."""
    key = (strategy, shards, cascade)
    if key not in _REFERENCE:
        eng = build(False, strategy, shards, cascade, True)
        _REFERENCE[key] = (drive(eng), observe(eng))
    return _REFERENCE[key]


def check_cell(strategy, shards, cascade, pipeline):
    ref_results, ref_obs = reference(strategy, shards, cascade)
    eng = build(True, strategy, shards, cascade, pipeline)
    results = drive(eng)
    obs = observe(eng)
    for (f0, v0), (f1, v1) in zip(ref_results, results):
        np.testing.assert_array_equal(f1, f0)
        np.testing.assert_array_equal(v1, v0)
    assert obs == ref_obs


# ------------------------------------------------------------ range scans
EXPIRED = (1 << 19, (1 << 19) + 2048)  # range-deleted just before scans


def scan_batches(seed: int) -> list:
    """Three scan batches: short ranges, long ranges, and edges (the
    expired range, ranges past the last key and past the universe, the
    full universe, shard-slab straddlers for 2 and 4 range shards)."""
    rng = np.random.default_rng(seed + 100)
    lo = rng.integers(0, UNIVERSE - 2048, 96)
    short = [(int(a), int(a + w))
             for a, w in zip(lo, rng.integers(1, 2048, 96))]
    lo = rng.integers(0, UNIVERSE - (1 << 18), 6)
    long = [(int(a), int(a + w))
            for a, w in zip(lo, rng.integers(1 << 16, 1 << 18, 6))]
    edges = [EXPIRED, (UNIVERSE - 64, 1 << 40), (UNIVERSE, UNIVERSE + 999),
             (0, UNIVERSE), (0, 1 << 40), (0, 1), (UNIVERSE - 1, UNIVERSE)]
    for shards in (2, 4):
        width = -(-UNIVERSE // shards)
        edges += [(s * width - 3000, s * width + 3000)
                  for s in range(1, shards)]
    return [short, long, edges]


def drive_scans(eng, seed: int = 0):
    """Puts, point deletes and range deletes spread over the whole key
    universe (so range partitioning spreads them over the shards), a
    lookup batch after every round, one more range delete, then the
    ``scan_batches``.  Returns (lookup results, scan results)."""
    rng = np.random.default_rng(seed)
    gets = []
    for _ in range(4):
        k = rng.integers(0, UNIVERSE, 1500).astype(np.uint64)
        eng.put_batch(k, k * np.uint64(3) + np.uint64(1))
        eng.delete_batch(k[rng.integers(0, len(k), 100)])
        # Narrow deletes around loaded keys (decomp writes a tombstone
        # per key of a range).
        width = rng.integers(1, 24, 150)
        lo = np.maximum(k[rng.integers(0, len(k), 150)].astype(np.int64)
                        - width // 2, 0)
        eng.range_delete_batch([(int(a), int(a + w))
                                for a, w in zip(lo, width)])
        q = np.concatenate([k[:600],
                            rng.integers(0, UNIVERSE, 600).astype(np.uint64)])
        found, vals = eng.get_batch(q)
        gets.append((found.copy(), vals.copy()))
    eng.range_delete(*EXPIRED)
    scans = [[(k.copy(), v.copy()) for k, v in eng.range_scan_batch(b)]
             for b in scan_batches(seed)]
    return gets, scans


def assert_same_scans(got: list, want: list) -> None:
    """Scan batches equal byte for byte: keys, values and dtypes."""
    assert len(got) == len(want)
    for gb, wb in zip(got, want):
        assert len(gb) == len(wb)
        for (gk, gv), (wk, wv) in zip(gb, wb):
            assert gk.dtype == wk.dtype and gv.dtype == wv.dtype
            assert gk.tobytes() == wk.tobytes()
            assert gv.tobytes() == wv.tobytes()


_SCAN_REFERENCE: dict = {}


def scan_reference(strategy: str, shards: int, partition: str):
    key = (strategy, shards, partition)
    if key not in _SCAN_REFERENCE:
        eng = build(False, strategy, shards, True, True,
                    partition=partition)
        _SCAN_REFERENCE[key] = (drive_scans(eng), observe(eng))
    return _SCAN_REFERENCE[key]


def check_scan_cell(strategy, shards, partition, pipeline):
    (ref_gets, ref_scans), ref_obs = scan_reference(strategy, shards,
                                                    partition)
    eng = build(True, strategy, shards, True, pipeline, partition=partition)
    gets, scans = drive_scans(eng)
    obs = observe(eng)
    for (f0, v0), (f1, v1) in zip(ref_gets, gets):
        np.testing.assert_array_equal(f1, f0)
        np.testing.assert_array_equal(v1, v0)
    assert_same_scans(scans, ref_scans)
    assert obs == ref_obs
    # The full-universe scan is not empty, and merges took the hook.
    assert len(scans[2][3][0]) > 1000
    assert obs["kernels"]["merge_calls"] > 0
