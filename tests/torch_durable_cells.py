"""Shared cells of the durability suites: ``repro_torch.durable`` on the
CPU against ``repro.durable``.

Both packages get the reference suite's tiny store (buffer 32, T = 4,
GLORAN index buffer 16, EVE capacity 64) so short op streams cross
flush, compaction and index-flush points; the JAX engine runs with
``devices=0, procs=0, pipeline=False``, as ``tests/test_durable.py``
runs it.  A store is observed through lookups of every 37th key, one
scan of the whole universe, and every shard's level shapes, ``seq`` and
``num_entries``; two stores are the same when all of these are equal,
integers compared exactly.
"""

import glob
import os

import numpy as np

from repro.core import GloranConfig as JGloranConfig
from repro.core import LSMDRTreeConfig as JIndexConfig
from repro.core import RAEConfig as JRAEConfig
from repro.durable import recover as jrecover
from repro.engine import Engine as JEngine
from repro.engine import EngineConfig as JEngineConfig
from repro.lsm import LSMConfig as JLSMConfig
from repro_torch.core import GloranConfig, LSMDRTreeConfig, RAEConfig
from repro_torch.durable import recover
from repro_torch.durable.wal import shard_dir
from repro_torch.engine import Engine, EngineConfig
from repro_torch.engine.plan import OP_DELETE, OP_PUT, OP_RANGE_DELETE
from repro_torch.lsm import LSMConfig

UNIVERSE = 1 << 16


def configs(torch_side: bool):
    L, G, D, R = ((LSMConfig, GloranConfig, LSMDRTreeConfig, RAEConfig)
                  if torch_side else
                  (JLSMConfig, JGloranConfig, JIndexConfig, JRAEConfig))
    lsm = L(buffer_capacity=32, size_ratio=4, key_size=16, value_size=16,
            key_universe=UNIVERSE)
    gl = G(index=D(buffer_capacity=16, size_ratio=4, key_size=16),
           eve=R(capacity=64, key_universe=UNIVERSE))
    return lsm, gl


def exec_config(torch_side: bool, **kw):
    """The CPU execution config of either package (no WAL unless asked)."""
    kw.setdefault("pipeline", False)
    if torch_side:
        return EngineConfig(device="cpu", **kw)
    return JEngineConfig(devices=0, procs=0, **kw)


def make_engine(torch_side: bool, wal_dir=None, *, shards=2,
                strategy="gloran", fsync="batch", segment_bytes=4 << 20,
                **kw):
    lsm, gl = configs(torch_side)
    cfg = exec_config(torch_side,
                      wal_dir=str(wal_dir) if wal_dir else None,
                      fsync=fsync, wal_segment_bytes=segment_bytes, **kw)
    cls = Engine if torch_side else JEngine
    return cls(shards, strategy=strategy, lsm_config=lsm, gloran_config=gl,
               config=cfg)


def recover_in(torch_side: bool, wal_dir, **kw):
    """Recover ``wal_dir`` with either package, on the CPU."""
    fn = recover if torch_side else jrecover
    return fn(str(wal_dir), config=exec_config(torch_side), **kw)


def mixed_ops(seed, n_batches=6, batch=48):
    """The reference suite's write stream: puts, point deletes, range
    deletes and one explicit flush."""
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(n_batches):
        keys = rng.integers(1, UNIVERSE - 1, batch).astype(np.uint64)
        ops.append(("put", keys, keys * np.uint64(2 + i)))
        if i % 2 == 0:
            ops.append(("del", keys[: batch // 4]))
        if i % 2 == 1:
            lo = int(rng.integers(1, UNIVERSE // 2))
            ops.append(("rdel", lo, lo + int(rng.integers(1, 2000))))
        if i == n_batches // 2:
            ops.append(("flush",))
    return ops


def apply_workload(eng, ops):
    for op in ops:
        if op[0] == "put":
            eng.put_batch(op[1], op[2])
        elif op[0] == "del":
            eng.delete_batch(op[1])
        elif op[0] == "rdel":
            eng.range_delete(op[1], op[2])
        else:
            eng.flush()


def observe(eng) -> dict:
    """What two stores must share: lookups, a full scan, and every
    shard's level shapes, ``seq`` and ``num_entries``."""
    probes = np.arange(1, UNIVERSE, 37, dtype=np.uint64)
    found, vals = eng.get_batch(probes)
    sk, sv = eng.range_scan(0, UNIVERSE)
    return {
        "found": found.tobytes(),
        "vals": vals[found].tobytes(),
        "scan": (sk.tobytes(), sv.tobytes()),
        "levels": [sh.tree.stats()["levels"] for sh in eng.shards],
        "seq": [int(sh.tree.seq) for sh in eng.shards],
        "entries": [int(sh.tree.num_entries) for sh in eng.shards],
    }


def assert_same_store(a, b) -> None:
    oa, ob = observe(a), observe(b)
    for key in oa:
        assert oa[key] == ob[key], key


def segment_files(wal_dir) -> dict:
    """Relative path -> bytes of every WAL segment under ``wal_dir``."""
    out = {}
    for p in sorted(glob.glob(os.path.join(str(wal_dir), "shard-*",
                                           "*.wal"))):
        with open(p, "rb") as f:
            out[os.path.relpath(p, str(wal_dir))] = f.read()
    return out


def truncate_wal_at(wal_dir, shard: int, cut: int) -> None:
    """Chop a shard's stream to its first ``cut`` bytes (across
    segments, in listing order): the simulated crash point."""
    sdir = shard_dir(str(wal_dir), shard)
    remaining = cut
    for seg in sorted(glob.glob(os.path.join(sdir, "*.wal"))):
        size = os.path.getsize(seg)
        if remaining >= size:
            remaining -= size
            continue
        with open(seg, "r+b") as f:
            f.truncate(remaining)
        remaining = 0


def crash_oracle(frames_per_shard: dict) -> dict:
    """The visible key -> value state the surviving frames imply,
    applied per shard (a shard's ops touch only the keys it owns)."""
    state: dict = {}
    for frames in frames_per_shard.values():
        shard_state: dict = {}
        for fr in frames:
            for i in range(len(fr)):
                k = int(fr.kinds[i])
                if k == OP_PUT:
                    shard_state[int(fr.keys[i])] = int(fr.vals[i])
                elif k == OP_DELETE:
                    shard_state.pop(int(fr.keys[i]), None)
                elif k == OP_RANGE_DELETE:
                    lo, hi = int(fr.los[i]), int(fr.his[i])
                    for kk in [kk for kk in shard_state if lo <= kk < hi]:
                        del shard_state[kk]
        state.update(shard_state)
    return state
