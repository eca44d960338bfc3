"""Range-delete baselines and workload harness.

The four baseline strategies from the paper's evaluation (§6) are
implemented inside :class:`repro_torch.lsm.LSMTree` (strategy= "decomp",
"lookup_delete", "scan_delete", "lrr") next to "gloran"; this package holds
the workload generator/executor used by every benchmark.
"""

from .workload import (WorkloadMix, WorkloadResult, make_tree, run_workload,
                       zipf_keys)

__all__ = ["WorkloadMix", "WorkloadResult", "make_tree", "run_workload",
           "zipf_keys"]
