"""Kimi K2: trillion-param MoE, 384 experts top-8 [arXiv:2501.kimi2;
unverified paper-table].

61L d_model=7168 64H (GQA kv=8) expert d_ff=2048 vocab=163840, one shared
expert.  ~1.03e12 params: AdamW fp32 state (~14 TB) cannot fit 512 v5e
chips, so this arch uses factored Adafactor states (DESIGN.md §4); note
the single-pod train cell is expected to exceed 16 GB/chip — params+grads
alone are 4.1 TB vs a 4 TB pod (recorded honestly in EXPERIMENTS.md).
"""

from .base import ModelConfig, MoEConfig

config = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,
    vocab=163840,
    head_dim=128,
    moe=MoEConfig(n_experts=384, top_k=8, d_expert=2048,
                  shared_expert=True),
    optimizer="adafactor",
    source="arXiv:2501.kimi2; unverified",
)
