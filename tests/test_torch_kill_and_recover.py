"""A real process death of the port's durable store, on the CPU.

The counterpart of the reference's ``scripts/kill_and_recover.py`` at
its sizes (seed 31, 200 batches of 512 keys over 2^20, 2 hash shards,
buffer 1024, GLORAN index buffer 128, EVE capacity 4096, the WAL fsynced
a batch): a child process streams into a ``repro_torch`` engine and is
killed with SIGKILL after 8 acked batches; ``repro_torch.durable.recover``
must serve every key the acked prefix and the in-flight batch wrote as
one stage of the oracle's envelope, and ``repro.durable.recover`` must
serve the same directory identically (the packages share the WAL
format).  The check must also see lost writes: against the envelope of
two batches more than were acked it reports mismatches.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import torch_kill_cells as cells
from repro.durable import recover as jrecover
from repro.engine import EngineConfig as JEngineConfig
from repro_torch.durable import recover

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def killed(tmp_path_factory):
    """A WAL directory whose writer was SIGKILLed mid-stream, and the
    number of batches it acked."""
    wal = str(tmp_path_factory.mktemp("killed") / "wal")
    os.makedirs(wal)
    n_acked = cells.kill_child(wal)
    with open(os.path.join(wal, cells.CHILD_MODULES)) as f:
        assert json.load(f) == [], "the child loaded jax or repro"
    return wal, n_acked


def recovered_copy(wal: str, dest: str, recover_fn, config):
    """Recover from a copy (recovery truncates torn tails and commits
    manifest edits in the directory it reads)."""
    shutil.copytree(wal, dest)
    return recover_fn(dest, config=config)


def test_sigkill_then_recover_serves_the_acked_prefix(killed, tmp_path):
    wal, n_acked = killed
    assert cells.KILL_AFTER <= n_acked < cells.N_BATCHES, n_acked
    env = cells.envelope(n_acked)
    keys = cells.written_keys(n_acked + 1)
    assert set(env[0]) <= set(keys.tolist())

    rec = recovered_copy(wal, str(tmp_path / "torch"), recover,
                         cells.engine_config())
    found, vals = rec.get_batch(keys)
    m = rec.stats()["metrics"]
    assert rec.recovery["frames_replayed"] > 0
    assert m["recovery.wall_s"] > 0.0
    rec.close()
    assert found.sum() >= len(env[0]) - 2 * cells.BATCH
    bad = cells.mismatches(keys, found, vals, env)
    assert not bad, f"{len(bad)} of {len(keys)} keys outside the " \
                    f"envelope after {n_acked} acked batches: {bad[:5]}"

    # The reference's recover on the same killed directory serves every
    # key alike.
    jrec = recovered_copy(wal, str(tmp_path / "jax"), jrecover,
                          JEngineConfig(procs=0, devices=0,
                                        pipeline=False))
    jfound, jvals = jrec.get_batch(keys)
    jrec.close()
    assert np.array_equal(found, np.asarray(jfound))
    assert np.array_equal(vals[found], np.asarray(jvals)[found])


def test_envelope_of_unissued_batches_is_rejected(killed, tmp_path):
    """A planted fault: holding the store to two batches more than were
    acked claims writes that were never issued; the check must report
    them as lost."""
    wal, n_acked = killed
    rec = recovered_copy(wal, str(tmp_path / "torch"), recover,
                         cells.engine_config())
    keys = cells.written_keys(n_acked + 3)
    found, vals = rec.get_batch(keys)
    rec.close()
    assert not cells.mismatches(keys, found, vals, cells.envelope(n_acked))
    bad = cells.mismatches(keys, found, vals, cells.envelope(n_acked + 2))
    lost = [b for b in bad if not b[1]]
    assert len(lost) > cells.BATCH // 2, (len(bad), len(lost))
