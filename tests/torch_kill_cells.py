"""The port's kill-and-recover check at the reference's sizes: the
counterpart of ``scripts/kill_and_recover.py`` on ``repro_torch`` (CPU).

A child process opens a durable engine (``fsync="batch"``) on a WAL
directory and streams seeded mixed batches (puts, point deletes, a range
delete, a flush every fifth batch).  After each batch's blocking calls
return it appends ``<batch index>`` to ``acked.log`` (write, flush,
fsync): the record of what durability was promised.  The parent waits
for a few acked batches, SIGKILLs the child (no shutdown path runs),
recovers the store from the directory and holds every key the acked
prefix and the in-flight batch wrote to the oracle's envelope.

This module imports ``repro_torch`` only (the child reports the modules
it loaded); ``tests/test_torch_kill_and_recover.py`` drives it.

    PYTHONPATH=src python tests/torch_kill_cells.py --child <wal_dir>
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np

UNIVERSE = 1 << 20
BATCH = 512
N_BATCHES = 200
SHARDS = 2
SEED = 31
KILL_AFTER = 8  # acked batches before the parent kills the child
ACKED = "acked.log"
CHILD_MODULES = "child_modules.json"  # jax / repro modules the child loaded
SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")


def make_batches():
    """The reference's seeded stream, which both processes derive:
    (keys, vals, point-deleted keys, (lo, hi), flush after it)."""
    rng = np.random.default_rng(SEED)
    out = []
    for i in range(N_BATCHES):
        keys = rng.integers(1, UNIVERSE - 1, BATCH).astype(np.uint64)
        vals = keys * np.uint64(2 + (i % 7))
        dels = keys[: BATCH // 8]
        lo = int(rng.integers(1, UNIVERSE // 2))
        rd = (lo, lo + int(rng.integers(64, 4096)))
        out.append((keys, vals, dels, rd, i % 5 == 4))
    return out


def engine_config(**kw):
    from repro_torch.engine import EngineConfig
    return EngineConfig(device="cpu", partition="hash", pipeline=False,
                        procs=0, **kw)


def build_engine(wal_dir: str):
    """The reference's store: buffer 1024, GLORAN index buffer 128, EVE
    capacity 4096, 2 hash shards, the WAL fsynced a batch."""
    from repro_torch.core import GloranConfig, LSMDRTreeConfig, RAEConfig
    from repro_torch.engine import Engine
    from repro_torch.lsm import LSMConfig
    lsm = LSMConfig(buffer_capacity=1024, key_size=16, value_size=16,
                    key_universe=UNIVERSE)
    glo = GloranConfig(
        index=LSMDRTreeConfig(buffer_capacity=128, key_size=16),
        eve=RAEConfig(capacity=4096, key_universe=UNIVERSE))
    return Engine(SHARDS, strategy="gloran", lsm_config=lsm,
                  gloran_config=glo,
                  config=engine_config(wal_dir=wal_dir, fsync="batch"))


def foreign_modules() -> list[str]:
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "repro"))


def child_main(wal_dir: str) -> None:
    import torch
    torch.set_num_threads(1)
    eng = build_engine(wal_dir)
    with open(os.path.join(wal_dir, CHILD_MODULES), "w") as f:
        json.dump(foreign_modules(), f)
    ack = open(os.path.join(wal_dir, ACKED), "w")
    for i, (keys, vals, dels, rd, do_flush) in enumerate(make_batches()):
        eng.put_batch(keys, vals)
        eng.delete_batch(dels)
        eng.range_delete(*rd)
        if do_flush:
            eng.flush()
        ack.write(f"{i}\n")
        ack.flush()
        os.fsync(ack.fileno())
    eng.close()  # only reached if the parent never kills


def acked_count(wal_dir: str) -> int:
    try:
        with open(os.path.join(wal_dir, ACKED)) as f:
            acked = [int(x) for x in f.read().split()]
    except OSError:
        return 0
    assert acked == list(range(len(acked))), acked
    return len(acked)


def kill_child(wal_dir: str, target: int = KILL_AFTER,
               timeout: float = 120.0) -> int:
    """Start the child on ``wal_dir``, SIGKILL it once ``target`` batches
    are acked, and return the acked count read after its death.  Raises
    if the child exits on its own or the acks do not come in time."""
    child = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--child", wal_dir],
        env={**os.environ, "PYTHONPATH": SRC},
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        deadline = time.monotonic() + timeout
        while acked_count(wal_dir) < target:
            if child.poll() is not None:
                raise AssertionError(
                    f"the child exited ({child.returncode}) before the "
                    f"kill: {child.stderr.read().decode()[-2000:]}")
            if time.monotonic() > deadline:
                raise AssertionError(f"fewer than {target} acked batches "
                                     f"after {timeout} s")
            time.sleep(0.05)
        child.send_signal(signal.SIGKILL)
        child.wait(timeout=30)
        assert child.returncode == -signal.SIGKILL, child.returncode
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=30)
        child.stderr.close()
    return acked_count(wal_dir)


def envelope(n_acked: int) -> list[dict]:
    """The states a recovered store may serve: [0] the acked prefix;
    [1..3] the in-flight batch's puts, then its point deletes, then its
    range delete.  Each of those is its own per-shard WAL frame, so any
    prefix of them may be durable on a given shard."""
    batches = make_batches()
    state: dict = {}
    for keys, vals, dels, (lo, hi), _ in batches[:n_acked]:
        state.update(zip(keys.tolist(), vals.tolist()))
        for k in dels.tolist():
            state.pop(k, None)
        for k in [k for k in state if lo <= k < hi]:
            del state[k]
    out = [state]
    if n_acked < N_BATCHES:
        keys, vals, dels, (lo, hi), _ = batches[n_acked]
        s1 = {**state, **dict(zip(keys.tolist(), vals.tolist()))}
        s2 = dict(s1)
        for k in dels.tolist():
            s2.pop(k, None)
        s3 = {k: v for k, v in s2.items() if not lo <= k < hi}
        out += [s1, s2, s3]
    return out


def written_keys(n_batches: int) -> np.ndarray:
    """Every key the first ``n_batches`` batches put, sorted, unique."""
    batches = make_batches()[:n_batches]
    return np.unique(np.concatenate([b[0] for b in batches]))


def mismatches(keys: np.ndarray, found: np.ndarray, vals: np.ndarray,
               env: list[dict]) -> list[tuple]:
    """Keys whose served state is no stage of ``env``: (key, found,
    value, each stage's value or None)."""
    bad = []
    for k, f, v in zip(keys.tolist(), found.tolist(), vals.tolist()):
        if not any((st.get(k) == v) if f else (k not in st) for st in env):
            bad.append((k, f, v, [st.get(k) for st in env]))
    return bad


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        child_main(sys.argv[2])
    else:
        sys.exit(f"usage: {sys.argv[0]} --child <wal_dir>")
