"""ChatGLM3-6B: GQA kv=2, 2-d RoPE (half dims) [arXiv:2406.12793; hf].

28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024.  rope_fraction=0.5
implements the 2-d RoPE (rotary on half the head dims).  Full attention ->
long_500k skipped.
"""

from .base import ModelConfig

config = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab=65024,
    head_dim=128,
    rope_fraction=0.5,
    source="arXiv:2406.12793; hf",
)
