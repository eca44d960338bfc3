"""MusicGen-Large: decoder-only over EnCodec tokens [arXiv:2306.05284; hf].

48L d_model=2048 32H (kv=32, MHA) d_ff=8192 vocab=2048.  The EnCodec audio
frontend is a STUB: input_specs() supplies precomputed frame embeddings
(B, S, d_model); the backbone + LM head over the codebook vocab are real.
Pure full attention -> long_500k is skipped (DESIGN.md §long_500k).
"""

from .base import ModelConfig

config = ModelConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=2048,
    head_dim=64,
    stub_frontend="audio",
    source="arXiv:2306.05284; hf",
)
