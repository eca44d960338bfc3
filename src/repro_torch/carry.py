"""Build the port's structures from another store's state given as
numpy arrays.

A test, or a migration, that holds an SSTable, a DR-tree level or a
Bloom filter of the JAX package as arrays rebuilds the same object
here, so that both packages can be fed identical state.  The cascade's
packed state has its own constructor, ``CascadeState.from_numpy``; a
model's parameters load with ``load_jax_params`` and leave with
``jax_params``, and ``param_leaves`` groups the port's per-layer
tensors by the JAX package's tree paths (for the optimizer's state and
checkpoints).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .core.drtree import DRTree
from .core.eve import BloomBits
from .lsm.format import LSMConfig
from .lsm.sstable import SSTable


def sstable_from_arrays(keys, seqs, types, vals, config: LSMConfig,
                        seed: int = 0) -> SSTable:
    """An SSTable from its sorted unique columns; ``seed`` fixes its
    Bloom filter, so the same seed rebuilds the same filter bits."""
    return SSTable(np.asarray(keys, np.uint64), np.asarray(seqs, np.uint64),
                   np.asarray(types, np.uint8), np.asarray(vals, np.uint64),
                   config, seed=seed)


def drtree_from_arrays(lo, hi, smin, smax, **kwargs) -> DRTree:
    """A DR-tree level from its key-disjoint (lo, hi, smin, smax)
    columns; ``kwargs`` are ``DRTree``'s sizing options."""
    return DRTree.from_arrays(*(np.asarray(a, np.uint64)
                                for a in (lo, hi, smin, smax)), **kwargs)


def bloom_from_arrays(words, m_bits: int, seeds) -> BloomBits:
    """A Bloom filter (an SSTable's, or an EVE estimator's) from its
    words, bit count and per-hash seeds."""
    seeds = np.asarray(seeds, np.uint32)
    bb = BloomBits(int(m_bits), len(seeds))
    if bb.m_bits != int(m_bits) or len(words) != len(bb.words):
        raise ValueError(f"filter of {m_bits} bits cannot hold "
                         f"{len(words)} words")
    bb.words = np.array(words, np.uint32)
    bb.seeds = seeds.copy()
    return bb


def _index(tree, i):
    """Slice ``i`` of every array of a nested dict."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _unstack(tree, *lead: int) -> list:
    """Nested lists (one level per leading axis) of a dict of stacked
    arrays."""
    if not lead:
        return tree
    return [_unstack(_index(tree, i), *lead[1:]) for i in range(lead[0])]


def load_jax_params(model, tree) -> None:
    """Fill a ``repro_torch.models.Transformer`` with the JAX package's
    param tree for the same config, given as numpy arrays: the stacked
    ``layers`` (L, ...), ``groups`` (G, per, ...) and ``tail`` (T, ...)
    are unstacked into the port's per-layer modules (an MoE layer's
    ``moe`` experts, (L, E, D, F) and the like, and its ``shared``
    expert with them), and every array is cast to the model's type on
    its device."""
    out = {k: tree[k] for k in ("embed", "final_norm", "lm_head",
                                "shared_attn", "shared_mlp") if k in tree}
    if "layers" in tree:
        out["layers"] = _unstack(tree["layers"], model.cfg.n_layers)
    if "groups" in tree:
        mamba = tree["groups"]["mamba"]
        out["groups"] = _unstack(mamba, *mamba["ln"].shape[:2])
    if "tail" in tree:
        mamba = tree["tail"]["mamba"]
        out["tail"] = _unstack(mamba, mamba["ln"].shape[0])
    model.load_params(out)


@dataclass
class Leaf:
    """One leaf of the JAX package's param tree: its path
    (``groups/mamba/w_in``), its stacked layer axes (``lead``: () for an
    unstacked leaf, (L,), (G, per) or (T,)) and the port's tensors of
    that path, one a layer in row-major order over ``lead``."""
    path: str
    lead: tuple
    parts: list

    @property
    def part_shape(self) -> tuple:
        return tuple(self.parts[0].shape)

    @property
    def shape(self) -> tuple:
        return self.lead + self.part_shape


def tree_order(path: str) -> list:
    """Sort key of a tree path in ``jax.tree`` flatten order (dict keys
    sorted level by level)."""
    return path.split("/")


def param_leaves(model) -> list[Leaf]:
    """The model's parameters grouped as the JAX package's leaves, in
    its flatten order."""
    p = model.params
    out: dict[str, Leaf] = {}

    def add(prefix: str, lead: tuple, layers: list) -> None:
        named = [dict(t.named_parameters()) for t in layers]
        for name in named[0]:
            path = prefix + name.replace(".", "/")
            out[path] = Leaf(path, lead, [n[name] for n in named])

    for name in ("embed", "final_norm", "lm_head"):
        if name in p:
            out[name] = Leaf(name, (), [p[name]])
    for name in ("shared_attn", "shared_mlp"):
        if name in p:
            add(name + "/", (), [p[name]])
    if "layers" in p:
        add("layers/", (len(p["layers"]),), list(p["layers"]))
    if "groups" in p:
        groups = p["groups"]
        add("groups/mamba/", (len(groups), len(groups[0])),
            [lp for g in groups for lp in g])
    if "tail" in p:
        add("tail/mamba/", (len(p["tail"]),), list(p["tail"]))
    return [out[k] for k in sorted(out, key=tree_order)]


def nest(flat: dict) -> dict:
    """A nested dict from one keyed by tree paths."""
    out: dict = {}
    for path, value in flat.items():
        *head, last = path.split("/")
        node = out
        for k in head:
            node = node.setdefault(k, {})
        node[last] = value
    return out


def _stacked(leaf: Leaf) -> np.ndarray:
    """A leaf's parts stacked on the host in f32 (exact for bf16)."""
    arr = np.stack([t.detach().float().cpu().numpy() for t in leaf.parts])
    return arr.reshape(leaf.shape)


def jax_params(model) -> dict:
    """The model's parameters as the JAX package's param tree: stacked
    numpy arrays under its keys, bf16 given as f32 (exact; the
    reference's ``astype`` restores the type).  The inverse of
    ``load_jax_params``."""
    return nest({leaf.path: _stacked(leaf) for leaf in param_leaves(model)})


def param_template(model) -> dict:
    """The JAX package's param tree as shapes and the model's type, on
    the meta device (no memory): a checkpoint restore's template."""
    return nest({leaf.path: torch.empty(leaf.shape, dtype=model.dtype,
                                        device="meta")
                 for leaf in param_leaves(model)})
