"""Zamba2-7B: Mamba2 backbone + shared attention blocks
[arXiv:2411.15242; unverified].

81L d_model=3584 (78 Mamba2 layers in 13 groups of 6 + 3 tail layers; a
single SHARED attention+MLP block applied after each group — per-group
LoRA deltas omitted, noted in DESIGN.md), 32H (kv=32) d_ff=14336
vocab=32000, ssm_state=64.  112 SSD heads not 16-divisible -> unsharded;
shared-attn KV cache shards kv_heads (32/16=2).  long_500k runs with the
shared attention in ring-buffer window mode (DESIGN.md).
"""

from .base import ModelConfig, SSMConfig

config = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab=32000,
    head_dim=112,
    hybrid_attn_every=6,
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, conv_width=4,
                  chunk=128),
    sharding_overrides={"ssm_heads": None, "cache_dim": None,
                        "cache_heads": "model"},
    source="arXiv:2411.15242; unverified",
)
