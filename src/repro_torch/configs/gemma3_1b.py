"""Gemma3-1B: 5:1 local:global attention, 128k ctx
[hf:google/gemma-3-1b-pt; unverified].

26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144, head_dim=256,
local window 512.  Per-layer window vector drives the 5 local + 1 global
pattern through a single scanned stack.  4 heads < 16-way model axis ->
head_dim (256) carries the tensor-parallel shard.
"""

from .base import ModelConfig

config = ModelConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    d_ff=6912,
    vocab=262144,
    head_dim=256,
    local_global=5,
    local_window=512,
    sharding_overrides={"cache_dim": "model"},
    source="hf:google/gemma-3-1b-pt; unverified",
)
