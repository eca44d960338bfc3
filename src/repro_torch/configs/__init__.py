"""Architecture registry: the 10 assigned archs (a copy of
``repro.configs``).

Usage: ``get_config("mixtral-8x7b")`` / ``--arch mixtral-8x7b`` in the
launchers.  ``ARCHS`` lists every id; each module defines ``config``.
"""

from .base import SHAPES, ModelConfig, MoEConfig, ShapeConfig, SSMConfig, smoke

from . import (chatglm3_6b, gemma3_1b, h2o_danube3_4b, kimi_k2_1t_a32b,
               mamba2_130m, minitron_8b, mixtral_8x7b, musicgen_large,
               paligemma_3b, zamba2_7b)

_REGISTRY = {
    m.config.name: m.config
    for m in (musicgen_large, mixtral_8x7b, kimi_k2_1t_a32b, minitron_8b,
              h2o_danube3_4b, chatglm3_6b, gemma3_1b, mamba2_130m,
              zamba2_7b, paligemma_3b)
}

ARCHS = tuple(sorted(_REGISTRY))


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {ARCHS}")
    return _REGISTRY[name]


__all__ = ["ARCHS", "SHAPES", "ModelConfig", "MoEConfig", "ShapeConfig",
           "SSMConfig", "get_config", "smoke"]
