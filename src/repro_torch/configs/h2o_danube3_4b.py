"""H2O-Danube3-4B: llama+mistral mix with SWA [arXiv:2401.16818;
unverified].

24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000, window 4096.
head_dim=120: neither kv_heads(8) nor head_dim(120) divides the 16-way
model axis, so the KV cache shards its sequence dim over 'model'
(context-parallel decode) — see sharding_overrides.
"""

from .base import ModelConfig

config = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_ff=10240,
    vocab=32000,
    head_dim=120,
    window=4096,
    sharding_overrides={"cache_dim": None, "cache_seq": "model"},
    source="arXiv:2401.16818; unverified",
)
