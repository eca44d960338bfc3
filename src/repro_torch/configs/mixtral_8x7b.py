"""Mixtral-8x7B: sparse MoE, 8 experts top-2, SWA [arXiv:2401.04088; hf].

32L d_model=4096 32H (GQA kv=8) expert d_ff=14336 vocab=32000, sliding
window 4096.  8 experts < 16-way model axis -> experts replicated, expert
FFN dim tensor-parallel instead (sharding_overrides).
"""

from .base import ModelConfig, MoEConfig

config = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=32000,
    head_dim=128,
    window=4096,
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=14336),
    sharding_overrides={"experts": None, "expert_out": "model"},
    source="arXiv:2401.04088; hf",
)
