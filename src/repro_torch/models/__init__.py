"""LM model stack on torch: dense, MoE, SSM and hybrid decoders whose
prefill runs through the hand-written SSD and flash-attention kernels,
with logical-axis sharding onto a DeviceMesh."""

from .model import ParamTree, Transformer, param_specs, stacked_param_specs
from .moe import moe_aux_loss, moe_ffn
from .params import (ParamSpec, count_params, distribute_tree, init_params,
                     tree_abstract, tree_shardings)
from .sharding import (DEFAULT_RULES, NamedSharding, ShardingRules,
                       constrain, sharding_for)

__all__ = ["DEFAULT_RULES", "NamedSharding", "ParamSpec", "ParamTree",
           "ShardingRules", "Transformer", "constrain", "count_params",
           "distribute_tree", "init_params", "moe_aux_loss", "moe_ffn",
           "param_specs", "sharding_for", "stacked_param_specs",
           "tree_abstract", "tree_shardings"]
