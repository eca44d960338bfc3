"""Architecture + shape configuration dataclasses.

One ``ModelConfig`` describes any member of the assigned architecture pool
(dense / MoE / SSM / hybrid / VLM / audio backbones); ``ShapeConfig`` is one
input-shape cell; ``smoke()`` derives the reduced same-family config used by
CPU tests.  A copy of ``repro.configs.base`` (pure dataclasses), so that
the port imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    d_expert: int = 14336  # per-expert FFN hidden dim
    capacity_factor: float = 1.25
    shared_expert: bool = False  # kimi-style shared expert alongside routed


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64  # P per SSM head
    expand: int = 2  # d_inner = expand * d_model
    conv_width: int = 4
    chunk: int = 128


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None  # default d_model // n_heads
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    window: int | None = None  # sliding-window size (SWA archs)
    local_global: int | None = None  # gemma3: N local layers per 1 global
    local_window: int | None = None  # window of the local layers
    hybrid_attn_every: int | None = None  # zamba2: shared attn period
    rope_fraction: float = 1.0  # chatglm applies RoPE to half the dims
    stub_frontend: str | None = None  # 'audio' | 'vision' (embeddings input)
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    # Distribution knobs (see DESIGN.md):
    optimizer: str = "adamw"  # kimi-k2 -> "adafactor"
    remat: str = "full"  # full | none
    scan_layers: bool = True
    sharding_overrides: dict = field(default_factory=dict)
    source: str = ""

    @property
    def head_dim_(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run long_500k decode? (bounded attention state or
        attention-free; see DESIGN.md §long_500k skips)."""
        return (self.family in ("ssm", "hybrid") or self.window is not None
                or self.local_global is not None)

    def n_params(self) -> int:
        """Approximate parameter count (embedding + blocks + head)."""
        d, l = self.d_model, self.n_layers
        hd = self.head_dim_
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + \
            self.n_heads * hd * d
        if self.family == "ssm":
            attn = 0
        if self.moe is not None:
            ffn = 3 * d * self.moe.d_expert * self.moe.n_experts
            if self.moe.shared_expert:
                ffn += 3 * d * self.moe.d_expert
            ffn += d * self.moe.n_experts  # router
        elif self.d_ff > 0:
            ffn = 3 * d * self.d_ff
        else:
            ffn = 0
        ssm = 0
        if self.ssm is not None:
            di = self.ssm.expand * d
            nh = di // self.ssm.head_dim
            ssm = d * (2 * di + 2 * self.ssm.d_state + nh) + di * d + \
                di * self.ssm.conv_width
        per_layer = attn + ffn + ssm + 2 * d
        if self.family == "hybrid":
            nm = l  # mamba layers
            na = max(1, l // (self.hybrid_attn_every or 6))
            per = ssm + 2 * d
            shared = attn + 3 * d * self.d_ff
            return emb + nm * per + shared + 2 * d
        return emb + l * per_layer + 2 * d

    def n_active_params(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        if self.moe is None:
            return self.n_params()
        d, l = self.d_model, self.n_layers
        routed_all = 3 * d * self.moe.d_expert * self.moe.n_experts * l
        routed_act = 3 * d * self.moe.d_expert * self.moe.top_k * l
        return self.n_params() - routed_all + routed_act


@dataclass(frozen=True)
class ShapeConfig:
    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def tokens(self) -> int:
        # decode processes 1 new token/sequence against a seq_len cache
        return self.global_batch * (1 if self.kind == "decode"
                                    else self.seq_len)


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


def smoke(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    kw: dict = dict(
        n_layers=min(cfg.n_layers, 4 if cfg.family != "hybrid" else 7),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads
        else 4,
        d_ff=256 if cfg.d_ff > 0 else 0,
        vocab=256,
        head_dim=32,
        window=min(cfg.window, 32) if cfg.window else None,
        local_window=min(cfg.local_window, 16) if cfg.local_window else None,
        local_global=cfg.local_global,
        hybrid_attn_every=3 if cfg.hybrid_attn_every else None,
    )
    if cfg.moe is not None:
        kw["moe"] = MoEConfig(n_experts=min(cfg.moe.n_experts, 8),
                              top_k=min(cfg.moe.top_k, 2), d_expert=64,
                              capacity_factor=2.0,
                              shared_expert=cfg.moe.shared_expert)
    if cfg.ssm is not None:
        kw["ssm"] = SSMConfig(d_state=16, head_dim=16, expand=2,
                              conv_width=4, chunk=16)
    kw["dtype"] = "float32"
    kw["sharding_overrides"] = {}
    return replace(cfg, **kw)
