"""Range scans through the port's engine under range partitioning:
``repro_torch.engine.Engine`` on the CPU against ``repro.engine.Engine``
on ``test_torch_engine_scans.py``'s op stream and scan batches (scans
clipped to the shards' key slabs and concatenated in slab order), across
5 strategies x shards {1, 2, 4} x pipeline {on, off}.
"""

import pytest
import torch

from repro_torch.lsm import STRATEGIES
from torch_engine_cells import check_scan_cell

torch.set_num_threads(1)


@pytest.mark.parametrize("pipeline", (True, False))
@pytest.mark.parametrize("shards", (1, 2, 4))
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_range_partitioned_scans_match_reference(strategy, shards, pipeline):
    check_scan_cell(strategy, shards, "range", pipeline)
