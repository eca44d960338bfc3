"""repro_torch.engine: sharded, batched writes and point lookups over
LSM-tree shards, with the filter stage on a torch device.

Organized as **plan -> submit -> collect**: typed columnar ``OpBatch``es
are compiled by a ``Planner`` into per-shard ``ShardPlan``s, launched by
``Engine.submit`` (concurrently across shards when pipelining is on),
and merged back in request order by the returned ``PendingBatch``.
Lookups run through the fused CUDA cascade over each shard's
device-resident ``DeviceFilterRegistry`` packs, or the per-level bloom
and interval kernels when the cascade declines; compactions order
their merges through the merge-rank kernel.
"""

from .cache import BlockCache
from .engine import Engine
from .executor import EngineConfig, ShardExecutor
from .pending import PendingBatch
from .plan import (KIND_CODES, KIND_NAMES, OP_DELETE, OP_GET, OP_PUT,
                   OP_RANGE_DELETE, OP_RANGE_SCAN, OpBatch, Plan, Planner,
                   PlanStep, ShardPlan)
from .registry import CascadeView, DeviceFilterRegistry
from .router import ShardRouter
from .stats import EngineStats, KernelCounters, merge_io_snapshots

__all__ = ["BlockCache", "Engine", "EngineConfig", "ShardExecutor",
           "ShardRouter", "EngineStats", "KernelCounters",
           "merge_io_snapshots", "OpBatch", "Plan", "Planner", "PlanStep",
           "ShardPlan", "PendingBatch", "CascadeView",
           "DeviceFilterRegistry", "KIND_CODES", "KIND_NAMES",
           "OP_PUT", "OP_DELETE", "OP_GET", "OP_RANGE_DELETE",
           "OP_RANGE_SCAN"]
