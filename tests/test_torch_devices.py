"""Shard placement in ``repro_torch`` (``EngineConfig.devices``), on the
CPU: ``shard_devices``' contract against a faked card count, the
engine's device map and ``stats()["devices"]``, the device matrix
(every strategy and shard count, identical to ``devices=0`` and to the
JAX package's single-device engine), and the per-device upload
ledger."""

import numpy as np
import pytest
import torch

from repro.core import GloranConfig as JGloranConfig
from repro.core import LSMDRTreeConfig as JIndexConfig
from repro.core import RAEConfig as JRAEConfig
from repro.engine import Engine as JEngine
from repro.engine import EngineConfig as JEngineConfig
from repro.lsm import LSMConfig as JLSMConfig
from repro_torch.core import GloranConfig, LSMDRTreeConfig, RAEConfig
from repro_torch.device import shard_devices
from repro_torch.engine import Engine, EngineConfig
from repro_torch.lsm import STRATEGIES, LSMConfig

torch.set_num_threads(1)

UNIVERSE = 1 << 20


def cuda(*ids):
    return [torch.device("cuda", i) for i in ids]


# ------------------------------------------------------ shard_devices
@pytest.mark.parametrize("shards,limit,count,want", [
    (8, 0, 4, None),                        # 0: every shard on `device`
    (8, None, 1, None),                     # auto on one card
    (8, None, 0, None),
    (8, None, 4, cuda(0, 1, 2, 3, 0, 1, 2, 3)),  # auto: up to 8 cards
    (2, None, 4, cuda(0, 1)),               # auto: up to num_shards
    (4, 1, 1, cuda(0, 0, 0, 0)),            # N = 1 pins to cuda:0
    (4, 1, 4, cuda(0, 0, 0, 0)),
    (6, 2, 4, cuda(0, 1, 0, 1, 0, 1)),
    (4, 8, 2, cuda(0, 1, 0, 1)),            # N capped at the count
])
def test_shard_devices_contract(monkeypatch, shards, limit, count, want):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    assert shard_devices(shards, "cuda", limit) == want


@pytest.mark.parametrize("limit,want", [(0, None), (None, None),
                                        (1, ["cpu"] * 3),
                                        (4, ["cpu"] * 3)])
def test_shard_devices_on_the_cpu(monkeypatch, limit, want):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    got = shard_devices(3, "cpu", limit)
    assert (None if got is None else [str(d) for d in got]) == want


def test_shard_devices_pinned_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        shard_devices(4, "cuda", 2)


# ------------------------------------------------------------ engines
def small(torch_side: bool, strategy: str):
    L, G, D, R = ((LSMConfig, GloranConfig, LSMDRTreeConfig, RAEConfig)
                  if torch_side else
                  (JLSMConfig, JGloranConfig, JIndexConfig, JRAEConfig))
    lsm = L(buffer_capacity=64, size_ratio=3, key_size=16, value_size=48,
            block_size=512, key_universe=UNIVERSE)
    gl = (G(index=D(buffer_capacity=16, size_ratio=3, key_size=16,
                    block_size=512),
            eve=R(capacity=64, key_universe=UNIVERSE))
          if strategy == "gloran" else None)
    return lsm, gl


def build(strategy, shards, devices, torch_side=True, seed=42):
    """The reference device suite's engine and ``drive`` stream (a
    mixed put/delete/range-delete workload with plenty of flushes)."""
    lsm, gl = small(torch_side, strategy)
    kw = dict(cache_blocks=512, kernel_min_batch=1, kernel_min_areas=1,
              kernel_min_filter=1, devices=devices, procs=0)
    cfg = (EngineConfig(device="cpu", **kw) if torch_side else
           JEngineConfig(cascade_compiled=True, **kw))
    eng = (Engine if torch_side else JEngine)(
        num_shards=shards, strategy=strategy, lsm_config=lsm,
        gloran_config=gl, config=cfg)
    rng = np.random.default_rng(seed)
    for _ in range(4):
        keys = rng.integers(0, 2000, size=220).astype(np.uint64)
        eng.put_batch(keys, keys * np.uint64(3) + np.uint64(1))
        eng.delete_batch(rng.integers(0, 2000, size=30).astype(np.uint64))
        for _ in range(5):
            lo = int(rng.integers(0, 2000 - 80))
            eng.range_delete(lo, lo + int(rng.integers(1, 64)))
    return eng


def io_snapshots(eng):
    return [sh.tree.io.snapshot() for sh in eng.shards]


def test_device_map_and_stats():
    base = build("gloran", 4, devices=0)
    pinned = build("gloran", 4, devices=2)
    try:
        assert base.devices is None
        assert [str(d) for d in pinned.devices] == ["cpu"] * 4
        assert base.device_map() == pinned.device_map() == \
            {s: "cpu" for s in range(4)}
        for eng, enabled in ((base, False), (pinned, True)):
            st = eng.stats()
            assert st["devices"] == {"enabled": enabled, "distinct": 1,
                                     "per_shard": eng.device_map()}
            assert st["device"] == "cpu"
            assert st["metrics"]["engine.devices"] == 1
    finally:
        base.close()
        pinned.close()


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("shards", (1, 2, 4))
def test_device_matrix_identical_to_single_device(strategy, shards):
    rng = np.random.default_rng(9)
    probe = rng.integers(0, 2100, size=600).astype(np.uint64)
    scan = [(0, 700), (900, 1600)]
    jax_eng = build(strategy, shards, 0, torch_side=False)
    base = build(strategy, shards, devices=0)
    engines = [jax_eng, base] + [build(strategy, shards, devices=n)
                                 for n in (1, 2, 4)]
    try:
        io_drive = io_snapshots(base)
        for eng in engines:
            assert io_snapshots(eng) == io_drive
        want_f, want_v = base.get_batch(probe)
        want_s = base.range_scan_batch(scan)
        for eng in engines[:1] + engines[2:]:
            f, v = eng.get_batch(probe)
            np.testing.assert_array_equal(f, want_f)
            np.testing.assert_array_equal(v[f], want_v[want_f])
            for (ka, va), (kb, vb) in zip(eng.range_scan_batch(scan),
                                          want_s):
                assert ka.tobytes() == kb.tobytes()
                assert va.tobytes() == vb.tobytes()
            assert io_snapshots(eng) == io_snapshots(base)
    finally:
        for eng in engines:
            eng.close()


def test_upload_ledger_per_device():
    """Packs upload once per device in steady state, never per batch,
    charged to the devices the shards were homed on."""
    eng = build("gloran", 4, devices=4)
    try:
        probe = np.arange(0, 1024, dtype=np.uint64)
        eng.get_batch(probe)
        kc = eng.kernel_counters
        led0 = kc.snapshot()["upload_bytes_by_device"]
        assert set(led0) == set(eng.device_map().values()) == {"cpu"}
        assert led0["cpu"] == kc.upload_bytes > 0
        for _ in range(3):
            eng.get_batch(probe)
        assert eng.kernel_counters.snapshot()["upload_bytes_by_device"] \
            == led0
        per_shard = [sh.kernels.upload_bytes_by_device for sh in eng.shards]
        assert all(set(p) == {"cpu"} and p["cpu"] > 0 for p in per_shard)
    finally:
        eng.close()
