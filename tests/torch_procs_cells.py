"""Shared cells of the worker-process suites: ``repro_torch``'s procs
engine on the CPU against ``repro``'s in-process engine and the port's.

Both packages get the reference procs suite's tiny store (buffer 64,
T = 3, GLORAN index buffer 16, EVE capacity 64, every kernel gate at 1)
and its ``drive`` stream: two rounds of puts, point deletes, two range
deletes, a lookup batch and two range scans.  The JAX engine runs as
``tests/test_procs.py`` runs its reference: ``procs=0, devices=0,
pipeline=False`` with the compiled cascade.  Integers are compared
exactly.
"""

import numpy as np

from repro.core.eve import RAEConfig as JRAEConfig
from repro.core.gloran import GloranConfig as JGloranConfig
from repro.core.lsm_drtree import LSMDRTreeConfig as JIndexConfig
from repro.engine import Engine as JEngine
from repro.engine import EngineConfig as JEngineConfig
from repro.lsm import LSMConfig as JLSMConfig
from repro_torch.core import GloranConfig, LSMDRTreeConfig, RAEConfig
from repro_torch.engine import Engine, EngineConfig
from repro_torch.lsm import LSMConfig

UNIVERSE = 1 << 20
COUNTED = ("interval_calls", "interval_queries", "bloom_calls",
           "bloom_queries", "merge_calls", "merge_keys", "cascade_calls",
           "cascade_queries", "cascade_packs", "upload_bytes")
GATES = dict(cache_blocks=256, kernel_min_batch=1, kernel_min_areas=1,
             kernel_min_filter=1)


def configs(torch_side: bool, strategy: str = "gloran"):
    L, G, D, R = ((LSMConfig, GloranConfig, LSMDRTreeConfig, RAEConfig)
                  if torch_side else
                  (JLSMConfig, JGloranConfig, JIndexConfig, JRAEConfig))
    lsm = L(buffer_capacity=64, size_ratio=3, key_size=16, value_size=48,
            block_size=512, key_universe=UNIVERSE)
    gl = G(index=D(buffer_capacity=16, size_ratio=3, key_size=16,
                   block_size=512),
           eve=R(capacity=64, key_universe=UNIVERSE))
    return lsm, gl


def exec_config(torch_side: bool, *, procs=0, devices=0, scheduler=False,
                pipeline=None, **kw):
    """Either package's CPU execution config; ``pipeline`` follows
    ``procs`` unless set, as the reference suite sets it."""
    kw = {**GATES, "procs": procs, "devices": devices,
          "scheduler": scheduler,
          "pipeline": bool(procs) if pipeline is None else pipeline, **kw}
    if torch_side:
        return EngineConfig(device="cpu", **kw)
    return JEngineConfig(cascade_compiled=True, **kw)


def make_engine(torch_side: bool = True, *, strategy="gloran", shards=4,
                **kw):
    lsm, gl = configs(torch_side)
    cls = Engine if torch_side else JEngine
    return cls(shards, strategy=strategy, lsm_config=lsm, gloran_config=gl,
               config=exec_config(torch_side, **kw))


def drive(eng, rounds=2, universe=2000, seed=7):
    """The reference suite's mixed workload; returns every result."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(rounds):
        keys = rng.integers(0, universe, size=220).astype(np.uint64)
        vals = rng.integers(1, 1 << 40, size=220, dtype=np.uint64)
        eng.put_batch(keys, vals)
        eng.delete_batch(keys[:30])
        lo = int(rng.integers(0, universe // 2))
        eng.range_delete_batch([(lo, lo + 400), (lo + 600, lo + 900)])
        probe = rng.integers(0, universe, size=300).astype(np.uint64)
        found, got = eng.get_batch(probe)
        out.append(("get", found, got))
        for k, v in eng.range_scan_batch([(0, universe // 3),
                                          (universe // 4, universe)]):
            out.append(("scan", k, v))
    return out


def assert_same_results(ref, got):
    """Found masks, values where found, and scans byte for byte."""
    assert len(ref) == len(got)
    for (tag_a, a1, a2), (tag_b, b1, b2) in zip(ref, got):
        assert tag_a == tag_b
        assert np.array_equal(a1, b1)
        if tag_a == "get":
            assert np.array_equal(a2[a1], b2[b1])
        else:
            assert a1.tobytes() == b1.tobytes()
            assert a2.tobytes() == b2.tobytes()


def observe(eng, results) -> dict:
    """What a cell compares after ``drive``: results, the fleet's
    ``IOStats``, entries and the counted kernel ledger."""
    st = eng.stats()
    return {"results": results, "io": st["io"], "entries": st["entries"],
            "kernels": {k: st["kernels"][k] for k in COUNTED}}


_REFS: dict = {}


def reference(torch_side: bool, strategy: str, scheduler: bool) -> dict:
    """The serial in-process run of either package, cached per
    (package, strategy, scheduler)."""
    key = (torch_side, strategy, scheduler)
    if key not in _REFS:
        eng = make_engine(torch_side, strategy=strategy, procs=0,
                          pipeline=False, scheduler=scheduler)
        try:
            _REFS[key] = observe(eng, drive(eng))
        finally:
            eng.close()
    return _REFS[key]


def assert_same_observed(got: dict, want: dict) -> None:
    assert_same_results(want["results"], got["results"])
    for key in ("io", "entries", "kernels"):
        assert got[key] == want[key], key
