"""The port's slice end to end, cascade on: ``repro_torch.engine.Engine``
on the CPU against ``repro.engine.Engine``.

The same op stream drives both engines at a small size (buffer 512,
T = 4, GLORAN index buffer 512) where levels, compactions through the
merge-rank hook and GLORAN DR-tree levels all occur.  Found masks and
values, every shard's ``IOStats`` snapshot and level shapes, the kernel
call and query counts and the total upload bytes must be equal, across
5 strategies x shards {1, 2, 4} x pipeline {on, off}.  The cascade-off
half of the matrix is ``test_torch_engine_perlevel.py``.
"""

import pytest
import torch

from repro_torch.lsm import STRATEGIES
from torch_engine_cells import build, check_cell, drive

torch.set_num_threads(1)


@pytest.mark.parametrize("pipeline", (True, False))
@pytest.mark.parametrize("shards", (1, 2, 4))
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_engine_matches_reference(strategy, shards, pipeline):
    check_cell(strategy, shards, True, pipeline)


def test_slice_exercises_every_kernel_path():
    """The matrix is only worth something if its cells reach the
    kernels: levels, merge-rank compactions, GLORAN levels in the
    cascade, and the per-level bloom and interval routes."""
    on = build(True, "gloran", 2, True, True)
    drive(on)
    kc = on.kernel_counters
    assert kc.cascade_calls > 0 and kc.merge_calls > 0
    assert all(sh.registry.view(sh.tree).state.G >= 1 for sh in on.shards)
    on.close()
    off = build(True, "gloran", 1, False, True)
    drive(off)
    kc = off.kernel_counters
    assert kc.bloom_calls > 0 and kc.interval_calls > 0
    assert kc.cascade_calls == 0
    off.close()
