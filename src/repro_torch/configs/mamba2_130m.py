"""Mamba2-130M: SSD state-space model, attention-free [arXiv:2405.21060;
unverified].

24L d_model=768, ssm_state=128, expand=2 (d_inner=1536, 24 SSD heads of
P=64), vocab=50280.  d_ff=0 (attention-free family).  vocab 50280 is not
16-divisible -> vocab replicated; 24 ssm heads not 16-divisible ->
ssm_heads unsharded, d_inner ('mlp') carries the model shard.
"""

from .base import ModelConfig, SSMConfig

config = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    head_dim=None,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_width=4,
                  chunk=128),
    sharding_overrides={"vocab": None, "ssm_heads": None},
    source="arXiv:2405.21060; unverified",
)
