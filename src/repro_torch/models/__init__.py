"""LM model stack on torch: dense, MoE, SSM and hybrid decoders whose
prefill runs through the hand-written SSD and flash-attention kernels."""

from .model import ParamTree, Transformer, param_specs
from .moe import moe_aux_loss, moe_ffn
from .params import ParamSpec, count_params, init_params

__all__ = ["ParamSpec", "ParamTree", "Transformer", "count_params",
           "init_params", "moe_aux_loss", "moe_ffn", "param_specs"]
