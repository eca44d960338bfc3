"""Model assembly: dense / MoE / SSM / hybrid decoder stacks as torch
modules.

The JAX package scans over stacked layer parameters; here every layer
has its own modules (``nn.ModuleList``s), and the heterogeneous stacks
are Python loops: gemma3's 5:1 local:global pattern is a per-layer
window int, zamba2's shared attention+MLP block runs after each group
of Mamba2 layers.  ``vlm`` and ``audio`` are dense stacks behind a stub
frontend that takes embeddings; an MoE stack is a dense one whose MLP
is ``moe_ffn`` (mixtral, kimi-k2).

Parameters live in ``Transformer.params``, a tree of modules indexed
like the JAX package's param dicts (``params["groups"][g][j]["w_in"]``),
drawn from ``init_params`` with a seed on the model's device, or loaded
from the JAX package's arrays by ``repro_torch.carry.load_jax_params``.

Entry points:
  forward_train(tokens|embeds)          -> logits, differentiable
  prefill(tokens|embeds)                -> (logits, cache)
  decode_step(token, cache, pos)        -> (logits, cache), in place

Parameters are frozen (``requires_grad=False``) unless
``trainable(True)`` is called, as a train step does; prefill and
decode run without gradients either way.

With ``cfg.remat == "full"`` ``forward_train`` recomputes each layer
(dense, SSM) or each group and tail layer (hybrid) in the backward, as
the JAX package's ``_maybe_remat`` does, so every kernel launches twice
a backward pass.

On a mesh: ``rules`` (resolved per arch as the JAX package does) map
each logical axis to mesh axes; ``shard(mesh)`` turns every parameter
into a DTensor placed by ``tree_shardings`` (the reference's
``in_shardings=params_sh``), and the entry points then take DTensor
inputs (``steps.batch_shardings``) and pin activations with the
reference's ``constrain`` calls.  Plain tensors an entry point makes
(positions, masks, buffers) are replicated on the mesh.
``device="meta"`` builds the full-size model with no memory, for the
dry-run.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..device import resolve_device
from .attention import attention_block
from .layers import rmsnorm, swiglu
from .moe import moe_ffn
from .params import ParamSpec, init_params, tree_abstract, tree_map
from .sharding import (ShardingRules, constrain, is_dtensor,
                       replicate_plain_tensors, sharding_for)
from .ssm import mamba2_block

P = ParamSpec
_DENSE = ("dense", "moe", "vlm", "audio")


def _module(value):
    if isinstance(value, dict):
        return ParamTree(value)
    return nn.ModuleList(_module(v) for v in value)


class ParamTree(nn.Module):
    """A nested dict of parameters: tensors become parameters (frozen
    until ``Transformer.trainable``),
    dicts ``ParamTree``s and lists ``nn.ModuleList``s; indexed by key
    like the JAX package's param dicts."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, torch.Tensor):
                self.register_parameter(
                    name, nn.Parameter(value, requires_grad=False))
            else:
                self.add_module(name, _module(value))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


def _attn_specs(c: ModelConfig) -> dict:
    hd = c.head_dim_
    return {
        "ln": P((c.d_model,), ("embed",), "ones"),
        "wq": P((c.d_model, c.n_heads, hd),
                ("embed_fsdp", "q_heads", "head_dim")),
        "wk": P((c.d_model, c.n_kv_heads, hd),
                ("embed_fsdp", "kv_heads", "head_dim")),
        "wv": P((c.d_model, c.n_kv_heads, hd),
                ("embed_fsdp", "kv_heads", "head_dim")),
        "wo": P((c.n_heads, hd, c.d_model),
                ("q_heads", "head_dim", "embed_fsdp")),
    }


def _mlp_specs(c: ModelConfig) -> dict:
    return {
        "ln": P((c.d_model,), ("embed",), "ones"),
        "w_gate": P((c.d_model, c.d_ff), ("embed_fsdp", "mlp")),
        "w_up": P((c.d_model, c.d_ff), ("embed_fsdp", "mlp")),
        "w_down": P((c.d_ff, c.d_model), ("mlp", "embed_fsdp")),
    }


def _moe_specs(c: ModelConfig) -> dict:
    m = c.moe
    out = {
        "ln": P((c.d_model,), ("embed",), "ones"),
        "router": P((c.d_model, m.n_experts), ("embed", None)),
        "w_gate": P((m.n_experts, c.d_model, m.d_expert),
                    ("experts", "embed_fsdp", "expert_out")),
        "w_up": P((m.n_experts, c.d_model, m.d_expert),
                  ("experts", "embed_fsdp", "expert_out")),
        "w_down": P((m.n_experts, m.d_expert, c.d_model),
                    ("experts", "expert_out", "embed_fsdp")),
    }
    if m.shared_expert:
        out["shared"] = {
            "w_gate": P((c.d_model, m.d_expert), ("embed_fsdp", "mlp")),
            "w_up": P((c.d_model, m.d_expert), ("embed_fsdp", "mlp")),
            "w_down": P((m.d_expert, c.d_model), ("mlp", "embed_fsdp")),
        }
    return out


def _mamba_specs(c: ModelConfig) -> dict:
    di = c.ssm.expand * c.d_model
    n = c.ssm.d_state
    nh = di // c.ssm.head_dim
    return {
        "ln": P((c.d_model,), ("embed",), "ones"),
        "w_in": P((c.d_model, 2 * di), ("embed_fsdp", "mlp")),
        "w_bc": P((c.d_model, 2 * n), ("embed_fsdp", None)),
        "w_dt": P((c.d_model, nh), ("embed_fsdp", "ssm_heads")),
        "dt_bias": P((nh,), ("ssm_heads",), "dt_bias"),
        "a_log": P((nh,), ("ssm_heads",), "a_log"),
        "d_skip": P((nh,), ("ssm_heads",), "ones"),
        "conv_w": P((c.ssm.conv_width, di), ("conv", "mlp")),
        "out_norm": P((di,), ("mlp",), "ones"),
        "w_out": P((di, c.d_model), ("mlp", "embed_fsdp")),
    }


def _hybrid_split(c: ModelConfig) -> tuple[int, int, int]:
    """(groups, layers a group, tail layers) of a hybrid stack."""
    per = c.hybrid_attn_every or 6
    n_groups, tail = divmod(c.n_layers, per)
    return n_groups, per, tail


def param_specs(c: ModelConfig) -> dict:
    """The spec tree of a config: the JAX package's, with each stacked
    layer axis unrolled into a list.  Allocates nothing."""
    specs: dict = {
        "final_norm": P((c.d_model,), ("embed",), "ones"),
        "lm_head": P((c.d_model, c.vocab), ("embed_fsdp", "vocab")),
    }
    if c.stub_frontend is None:
        specs["embed"] = P((c.vocab, c.d_model), ("vocab", "embed"),
                           "normal", 1.0)
    if c.family in _DENSE:
        # An MoE layer's routed experts take the dense MLP's place.
        ffn, specs_of = (("moe", _moe_specs) if c.moe is not None
                         else ("mlp", _mlp_specs))
        specs["layers"] = [{"attn": _attn_specs(c), ffn: specs_of(c)}
                           for _ in range(c.n_layers)]
    elif c.family == "ssm":
        specs["layers"] = [{"mamba": _mamba_specs(c)}
                           for _ in range(c.n_layers)]
    else:  # hybrid
        n_groups, per, tail = _hybrid_split(c)
        specs["groups"] = [[_mamba_specs(c) for _ in range(per)]
                           for _ in range(n_groups)]
        if tail:
            specs["tail"] = [_mamba_specs(c) for _ in range(tail)]
        specs["shared_attn"] = _attn_specs(c)
        specs["shared_mlp"] = _mlp_specs(c)
    return specs


def _stacked(tree, shape: tuple, axes: tuple):
    return tree_map(lambda s: ParamSpec(shape + s.shape, axes + s.axes,
                                        s.init, s.scale), tree)


def stacked_param_specs(c: ModelConfig) -> dict:
    """The JAX package's spec tree (``Transformer.param_specs`` there):
    each stack of layer specs as one spec with the leading ``layers``
    (L,), ``groups``/``stack`` (G, per) or tail ``layers`` (T,) axes,
    keyed by ``carry.param_leaves``' paths.  The optimizer state and
    checkpoints have this layout."""
    specs = param_specs(c)
    out = {k: v for k, v in specs.items()
           if k not in ("layers", "groups", "tail")}
    if "layers" in specs:
        out["layers"] = _stacked(specs["layers"][0], (c.n_layers,),
                                 ("layers",))
    if "groups" in specs:
        g = specs["groups"]
        out["groups"] = {"mamba": _stacked(g[0][0], (len(g), len(g[0])),
                                           ("groups", "stack"))}
    if "tail" in specs:
        out["tail"] = {"mamba": _stacked(specs["tail"][0],
                                         (len(specs["tail"]),),
                                         ("layers",))}
    return out


def spec_paths(tree, prefix: str = "") -> list:
    """(tree path, spec) of every spec of a nested dict."""
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += spec_paths(v, f"{prefix}{k}/")
        else:
            out.append((prefix + k, v))
    return out


def resolve_rules(cfg: ModelConfig, rules: ShardingRules | None,
                  model_par: int) -> ShardingRules:
    """Head sharding per arch, as the JAX package's ``Transformer``
    resolves it: shard q heads when ``model_par``-divisible, else shard
    head_dim (gemma3/paligemma: 4-8 heads of dim 256), else replicate
    (h2o/zamba: 120/112-dim heads); then the config's overrides."""
    rules = rules or ShardingRules()
    m = model_par
    if cfg.n_heads and cfg.n_heads % m == 0:
        q_rule, hd_rule = "model", None
    elif cfg.head_dim_ and cfg.head_dim_ % m == 0:
        q_rule, hd_rule = None, "model"
    else:
        q_rule, hd_rule = None, None
    kv_rule = "model" if (cfg.n_kv_heads and cfg.n_kv_heads % m == 0
                          and hd_rule is None) else None
    rules = rules.with_overrides(q_heads=q_rule, kv_heads=kv_rule,
                                 head_dim=hd_rule)
    if cfg.sharding_overrides:
        rules = rules.with_overrides(**cfg.sharding_overrides)
    return rules


class Transformer(nn.Module):
    # Tensor-parallel width of the production meshes ('model' axis).
    MODEL_PAR = 16

    def __init__(self, cfg: ModelConfig, rules: ShardingRules | None = None,
                 *, device: str = "cuda", seed: int = 0):
        super().__init__()
        if cfg.family not in _DENSE + ("ssm", "hybrid"):
            raise ValueError(cfg.family)
        self.cfg = cfg
        self.rules = resolve_rules(cfg, rules, self.MODEL_PAR)
        self.dtype = getattr(torch, cfg.dtype)
        # Static window for banded local attention (prefill): uniform-SWA
        # archs use cfg.window; local:global stacks the local window
        # (global layers take the full path).
        self._static_window = (cfg.local_window if cfg.local_global
                               else cfg.window)
        if device == "meta":
            tree = tree_abstract(param_specs(cfg), self.dtype)
        else:
            tree = self._draw(seed, resolve_device(device))
        self.params = ParamTree(tree)

    def param_specs(self) -> dict:
        """The JAX package's (stacked) spec tree of this model."""
        return stacked_param_specs(self.cfg)

    @property
    def mesh(self):
        """The DeviceMesh the parameters lie on, or None (plain)."""
        p = self.params["final_norm"]
        return p.device_mesh if is_dtensor(p) else None

    def shard(self, mesh) -> "Transformer":
        """Replace every parameter by a DTensor on ``mesh`` placed by
        ``tree_shardings`` of the stacked specs under ``self.rules``: a
        layer's tensor takes its leaf's placements less the leading
        layer axes, which the rules must leave replicated (the port
        keeps one tensor a layer)."""
        from ..carry import param_leaves
        specs = dict(spec_paths(self.param_specs()))
        owner = {id(p): (m, n) for m in self.params.modules()
                 for n, p in m._parameters.items()}
        for leaf in param_leaves(self):
            axes = specs[leaf.path].axes
            n = len(leaf.lead)
            lead = sharding_for(axes, mesh, self.rules).spec[:n]
            if any(lead):
                raise ValueError(f"{leaf.path}: the rules shard a layer "
                                 f"axis ({lead}); layers stay replicated")
            sh = sharding_for(axes[n:], mesh, self.rules)
            for part in leaf.parts:
                module, name = owner[id(part)]
                module._parameters[name] = nn.Parameter(
                    sh.distribute(part.detach()),
                    requires_grad=part.requires_grad)
        return self

    def _mesh_context(self):
        """Plain tensors made inside an entry point are replicated on
        the mesh (a no-op without one)."""
        return replicate_plain_tensors() if self.mesh is not None \
            else contextlib.nullcontext()

    def _draw(self, seed: int, device) -> dict:
        gen = torch.Generator(device=device).manual_seed(seed)
        return init_params(param_specs(self.cfg), gen, self.dtype, device)

    @torch.no_grad()
    def reseed(self, seed: int) -> None:
        """Draw every parameter anew as ``Transformer(cfg, seed=seed)``
        on this device does."""
        self._load(self._draw(seed, self.device), self.params)

    def trainable(self, flag: bool = True) -> "Transformer":
        """Let autograd reach the parameters (a train step), or freeze
        them again (serving)."""
        for p in self.params.parameters():
            p.requires_grad_(flag)
        return self

    @property
    def device(self) -> torch.device:
        """Where the parameters lie: ``model.to("cpu")`` moves the model
        and every tensor its entry points make."""
        return self.params["final_norm"].device

    @torch.no_grad()
    def load_params(self, tree) -> None:
        """Copy a tree of the spec tree's structure (tensors or numpy
        arrays) into the parameters; shapes must match."""
        self._load(tree, self.params)

    def _load(self, tree, params) -> None:
        keys = tree.keys() if isinstance(tree, dict) else range(len(tree))
        if isinstance(tree, list) and len(tree) != len(params):
            raise ValueError(f"{len(tree)} layers given for "
                             f"{len(params)}")
        for k in keys:
            src, dst = tree[k], params[k]
            if isinstance(dst, torch.Tensor):
                if not isinstance(src, torch.Tensor):
                    src = torch.from_numpy(np.array(src))
                if tuple(src.shape) != tuple(dst.shape):
                    raise ValueError(f"{k}: shape {tuple(src.shape)} for "
                                     f"{tuple(dst.shape)}")
                dst.copy_(src.to(dst.dtype))
            else:
                self._load(src, dst)

    # ----------------------------------------------------------- helpers
    def _window_vector(self) -> list[int]:
        """Per-layer attention window (-1 = full)."""
        c = self.cfg
        if c.local_global is not None:
            per = c.local_global + 1  # N local then 1 global
            return [(c.local_window or 1024) if (i % per) != c.local_global
                    else -1 for i in range(c.n_layers)]
        return [c.window if c.window is not None else -1] * c.n_layers

    def _attention(self, x, ap, window, positions, cache=None,
                   cache_pos=None, ring=False, static_local_window=None):
        return attention_block(
            rmsnorm(x, ap["ln"], self.cfg.norm_eps), ap["wq"], ap["wk"],
            ap["wv"], ap["wo"], positions=positions, window=window,
            rope_fraction=self.cfg.rope_fraction, rules=self.rules,
            cache=cache, cache_pos=cache_pos, ring=ring,
            static_local_window=static_local_window)

    def _mlp(self, x, mp):
        return x + swiglu(rmsnorm(x, mp["ln"], self.cfg.norm_eps),
                          mp["w_gate"], mp["w_up"], mp["w_down"])

    def _block_dense(self, x, lp, window, positions, cache=None,
                     cache_pos=None, ring=False):
        h, new_kv = self._attention(x, lp["attn"], window, positions, cache,
                                    cache_pos, ring, self._static_window)
        x = x + h
        if self.cfg.moe is None:
            x = self._mlp(x, lp["mlp"])
        else:
            mp, m = lp["moe"], self.cfg.moe
            x = x + moe_ffn(rmsnorm(x, mp["ln"], self.cfg.norm_eps),
                            mp["router"], mp["w_gate"], mp["w_up"],
                            mp["w_down"], top_k=m.top_k,
                            capacity_factor=m.capacity_factor,
                            rules=self.rules,
                            shared=mp["shared"] if "shared" in mp
                            else None)
        return constrain(x, ("batch", "act_seq", "embed"), self.rules), new_kv

    def _block_mamba(self, x, lp, state=None, return_state=False):
        y, new_state = mamba2_block(rmsnorm(x, lp["ln"], self.cfg.norm_eps),
                                    lp, self.cfg, self.rules, state=state,
                                    return_state=return_state)
        return constrain(x + y, ("batch", "act_seq", "embed"),
                         self.rules), new_state

    def _shared(self, x, positions, cache=None, cache_pos=None, ring=False):
        """zamba2's shared attention + MLP block."""
        c = self.cfg
        out, kv = self._attention(x, self.params["shared_attn"],
                                  c.window if c.window else -1, positions,
                                  cache, cache_pos, ring)
        return self._mlp(x + out, self.params["shared_mlp"]), kv

    def _embed_in(self, tokens, embeds):
        c = self.cfg
        if c.stub_frontend is not None:
            assert embeds is not None, "stub frontend takes embeddings"
            x = embeds.to(dtype=self.dtype) if is_dtensor(embeds) else \
                embeds.to(device=self.device, dtype=self.dtype)
        else:
            if not is_dtensor(tokens):
                tokens = torch.as_tensor(tokens, device=self.device)
            # A vocab-sharded table is gathered first: a gather from its
            # shards is a mask-partial sum, whose gradient torch 2.11's
            # DTensor cannot redistribute.
            table = constrain(self.params["embed"], (None, "embed"),
                              self.rules)
            x = F.embedding(tokens.long(), table).to(self.dtype)
            # The scale rounds to the model's type first, as in JAX.
            x = x * float(torch.tensor(c.d_model ** 0.5, dtype=self.dtype))
        return constrain(x, ("batch", "act_seq", "embed"), self.rules)

    def _head_out(self, x):
        x = rmsnorm(x, self.params["final_norm"], self.cfg.norm_eps)
        return constrain(x @ self.params["lm_head"], ("batch", None, "vocab"),
                         self.rules)

    def _positions(self, b: int, s: int, start: int = 0):
        return (torch.arange(s, dtype=torch.int32, device=self.device)
                + start)[None].expand(b, s)

    # ----------------------------------------------------- forward paths
    def forward_train(self, tokens=None, embeds=None):
        """Teacher-forced forward -> logits (B, S, V); differentiable,
        each remat unit (``_train_units``) recomputed in the backward
        under ``cfg.remat == "full"``."""
        with self._mesh_context():
            x = self._embed_in(tokens, embeds)
            positions = self._positions(x.shape[0], x.shape[1])
            remat = self.cfg.remat == "full"
            for unit in self._train_units(positions):
                x = checkpoint(unit, x, use_reentrant=False) if remat \
                    else unit(x)
            return self._head_out(x)

    def _train_units(self, positions) -> list:
        """The stack as the JAX package's remat units: a layer (dense,
        SSM), a group of Mamba2 layers with the shared block after it,
        or a tail layer (hybrid)."""
        c, p = self.cfg, self.params
        if c.family in _DENSE:
            return [lambda x, lp=lp, w=w:
                    self._block_dense(x, lp, w, positions)[0]
                    for lp, w in zip(p["layers"], self._window_vector())]
        if c.family == "ssm":
            return [lambda x, lp=lp: self._block_mamba(x, lp["mamba"])[0]
                    for lp in p["layers"]]
        units = [lambda x, g=g: self._shared(
                     self._mamba_run(x, g, False)[0], positions)[0]
                 for g in p["groups"]]
        return units + [lambda x, lp=lp: self._block_mamba(x, lp)[0]
                        for lp in (p["tail"] if "tail" in p else [])]

    @torch.no_grad()
    def prefill(self, tokens=None, embeds=None):
        """Forward + a KV/state cache sized to the input length; returns
        (last-position logits (B, 1, V), cache)."""
        with self._mesh_context():
            x = self._embed_in(tokens, embeds)
            x, cache = self._stack(x)
            return self._head_out(x[:, -1:]), cache

    def _stack(self, x):
        """Run every layer over the whole sequence; return the output
        and the cache (the JAX package's stacked layout)."""
        c = self.cfg
        p = self.params
        b, s, _ = x.shape
        positions = self._positions(b, s)
        if c.family in _DENSE:
            ks, vs = [], []
            for lp, w in zip(p["layers"], self._window_vector()):
                x, (k, v) = self._block_dense(x, lp, w, positions)
                ks.append(k)
                vs.append(v)
            return x, {"k": torch.stack(ks), "v": torch.stack(vs)}
        if c.family == "ssm":
            x, hs, convs = self._mamba_run(x, [lp["mamba"]
                                               for lp in p["layers"]], True)
            return x, {"h": hs, "conv": convs}
        cache: dict = {"gh": [], "gconv": [], "ak": [], "av": []}
        for group in p["groups"]:
            x, hs, convs = self._mamba_run(x, group, True)
            x, (k, v) = self._shared(x, positions)
            for key, val in zip(("gh", "gconv", "ak", "av"),
                                (hs, convs, k, v)):
                cache[key].append(val)
        cache = {k: torch.stack(v) for k, v in cache.items()}
        if "tail" in p:
            x, cache["th"], cache["tconv"] = self._mamba_run(x, p["tail"],
                                                             True)
        return x, cache

    def _mamba_run(self, x, layers, keep_cache: bool):
        hs, convs = [], []
        for lp in layers:
            x, st = self._block_mamba(x, lp, return_state=keep_cache)
            if keep_cache:
                hs.append(st["h"])
                convs.append(st["conv"])
        if not keep_cache:
            return x, None, None
        return x, torch.stack(hs), torch.stack(convs)

    # ------------------------------------------------------------- serve
    def init_cache(self, batch: int, max_len: int, dtype=None,
                   device=None) -> dict:
        """Zeroed decode cache on the model's device (or ``device``:
        "meta" gives its shapes without memory), in the JAX package's
        layout."""
        c = self.cfg
        dtype = dtype or self.dtype
        device = device or self.device
        hd = c.head_dim_

        def zeros(shape, dt=dtype):
            return torch.zeros(shape, dtype=dt, device=device)

        if c.family in _DENSE:
            shape = (c.n_layers, batch, max_len, c.n_kv_heads, hd)
            return {"k": zeros(shape), "v": zeros(shape)}
        di = c.ssm.expand * c.d_model
        nh = di // c.ssm.head_dim
        h = (batch, nh, c.ssm.d_state, c.ssm.head_dim)
        conv = (batch, c.ssm.conv_width - 1, di)
        if c.family == "ssm":
            return {"h": zeros((c.n_layers,) + h, torch.float32),
                    "conv": zeros((c.n_layers,) + conv)}
        n_groups, per, tail = _hybrid_split(c)
        kv = (n_groups, batch, max_len, c.n_kv_heads, hd)
        cache = {"gh": zeros((n_groups, per) + h, torch.float32),
                 "gconv": zeros((n_groups, per) + conv),
                 "ak": zeros(kv), "av": zeros(kv)}
        if tail:
            cache["th"] = zeros((tail,) + h, torch.float32)
            cache["tconv"] = zeros((tail,) + conv)
        return cache

    def cache_logical_axes(self) -> dict:
        """The logical axes of every ``init_cache`` leaf."""
        c = self.cfg
        kv = ("layers", "cache_batch", "cache_seq", "cache_heads",
              "cache_dim")
        if c.family in _DENSE:
            return {"k": kv, "v": kv}
        sh = ("layers", "cache_batch", "ssm_heads", None, None)
        cv = ("layers", "cache_batch", None, "mlp")
        if c.family == "ssm":
            return {"h": sh, "conv": cv}
        out = {"gh": ("groups",) + sh, "gconv": ("groups",) + cv,
               "ak": ("groups",) + kv[1:], "av": ("groups",) + kv[1:]}
        if _hybrid_split(c)[2]:
            out["th"] = sh
            out["tconv"] = cv
        return out

    @torch.no_grad()
    def decode_step(self, token, cache: dict, pos: int, ring: bool = False):
        """One decode step. token: (B, 1) int (or (B, 1, D) embeds for
        stub frontends); pos: the current position.  Updates ``cache``
        in place (it holds max_len positions for every layer, so a copy
        per step would double it) and returns (logits (B, 1, V),
        cache).  ``ring=True`` treats attention caches as circular window
        buffers (sliding-window long decode)."""
        with self._mesh_context():
            return self._decode(token, cache, pos, ring)

    def _decode(self, token, cache: dict, pos: int, ring: bool):
        c = self.cfg
        p = self.params
        if c.stub_frontend is not None:
            x = self._embed_in(None, token)
        else:
            x = self._embed_in(token, None)
        positions = self._positions(x.shape[0], 1, pos)
        if c.family in _DENSE:
            for i, (lp, w) in enumerate(zip(p["layers"],
                                            self._window_vector())):
                x, _ = self._block_dense(
                    x, lp, w, positions,
                    {"k": cache["k"][i], "v": cache["v"][i]}, pos, ring)
            return self._head_out(x), cache
        if c.family == "ssm":
            x = self._mamba_step(x, [lp["mamba"] for lp in p["layers"]],
                                 cache["h"], cache["conv"])
            return self._head_out(x), cache
        for g, group in enumerate(p["groups"]):
            x = self._mamba_step(x, group, cache["gh"][g], cache["gconv"][g])
            x, _ = self._shared(x, positions,
                                {"k": cache["ak"][g], "v": cache["av"][g]},
                                pos, ring)
        if "tail" in p:
            x = self._mamba_step(x, p["tail"], cache["th"], cache["tconv"])
        return self._head_out(x), cache

    def _mamba_step(self, x, layers, hs, convs):
        for i, lp in enumerate(layers):
            x, st = self._block_mamba(x, lp, {"h": hs[i], "conv": convs[i]})
            hs[i].copy_(st["h"])
            convs[i].copy_(st["conv"])
        return x
