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
          pipeline: bool):
    lsm, gl = _configs(torch_side, strategy)
    kw = dict(cache_blocks=64, use_cascade_kernel=cascade,
              pipeline=pipeline)
    if torch_side:
        cfg, cls = EngineConfig(device="cpu", **kw), Engine
    else:
        cfg = JEngineConfig(procs=0, devices=0, scheduler=False, **kw)
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
