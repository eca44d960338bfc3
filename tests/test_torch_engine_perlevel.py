"""The port's slice end to end, cascade off: every lookup takes the
per-level route (bloom and interval kernels) in both engines.  Same
cells and checks as ``test_torch_engine.py``: 5 strategies x shards
{1, 2, 4} x pipeline {on, off}."""

import pytest
import torch

from repro_torch.lsm import STRATEGIES
from torch_engine_cells import check_cell

torch.set_num_threads(1)


@pytest.mark.parametrize("pipeline", (True, False))
@pytest.mark.parametrize("shards", (1, 2, 4))
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_engine_matches_reference(strategy, shards, pipeline):
    check_cell(strategy, shards, False, pipeline)
