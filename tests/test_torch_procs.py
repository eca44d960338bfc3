"""Worker-process shard execution in ``repro_torch``: the reference
procs suite's always-on subset matrix, on the CPU.

Each cell (strategy x procs {2, 4} x devices {0, 4} x scheduler) drives
the reference suite's ``drive`` stream through the port's engine with
its shards in worker processes, and holds results, ``IOStats``, entries
and the kernel counters to the JAX package's in-process engine and to
the port's, exactly.  On the CPU ``devices=4`` pins every shard to the
CPU (``device.shard_devices``), so that axis runs the pinned path.
"""

import pytest
import torch

from torch_procs_cells import (assert_same_observed, drive, make_engine,
                               observe, reference)

torch.set_num_threads(1)

# The reference suite's SUBSET (tests/test_procs.py): every strategy and
# every mode axis covered.
SUBSET = [
    ("gloran", 2, 0, False), ("gloran", 2, 0, True),
    ("gloran", 2, 4, False), ("gloran", 4, 4, True),
    ("decomp", 2, 0, False), ("lookup_delete", 2, 0, True),
    ("scan_delete", 2, 4, False), ("lrr", 4, 0, True),
]


@pytest.mark.parametrize("strategy,procs,devices,scheduler", SUBSET)
def test_parity_matrix(strategy, procs, devices, scheduler):
    jax_ref = reference(False, strategy, scheduler)
    port_ref = reference(True, strategy, scheduler)
    assert_same_observed(port_ref, jax_ref)
    eng = make_engine(strategy=strategy, procs=procs, devices=devices,
                      scheduler=scheduler)
    try:
        assert eng.procs == procs
        got = observe(eng, drive(eng))
        assert_same_observed(got, jax_ref)
        assert_same_observed(got, port_ref)
        st = eng.stats()
        assert st["procs"] == procs
        assert st["devices"]["enabled"] == bool(devices)
        assert st["devices"]["distinct"] == 1
        assert st["proc"]["workers"] == procs
        assert st["proc"]["bytes_sent"] > 0
        assert st["proc"]["dequeue_latency_us"]["count"] > 0
        assert st["metrics"]["proc.workers"] == procs
    finally:
        eng.close()
