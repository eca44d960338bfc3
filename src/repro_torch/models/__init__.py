"""LM model stack on torch: dense, SSM and hybrid decoders whose
prefill runs through the hand-written SSD and flash-attention kernels."""

from .model import ParamTree, Transformer, param_specs
from .params import ParamSpec, count_params, init_params

__all__ = ["ParamSpec", "ParamTree", "Transformer", "count_params",
           "init_params", "param_specs"]
