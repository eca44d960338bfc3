"""PaliGemma-3B: SigLIP vision encoder + Gemma LM [arXiv:2407.07726; hf].

18L d_model=2048 8H (GQA kv=1) d_ff=16384 vocab=257216, head_dim=256.
The SigLIP frontend is a STUB: input_specs() supplies precomputed patch
embeddings; the Gemma backbone + head are real.  Full attention ->
long_500k skipped.  8 heads < 16-way model axis -> head_dim shards.
"""

from .base import ModelConfig

config = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    d_ff=16384,
    vocab=257216,
    head_dim=256,
    stub_frontend="vision",
    sharding_overrides={"cache_dim": "model"},
    source="arXiv:2407.07726; hf",
)
