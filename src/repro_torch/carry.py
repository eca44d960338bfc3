"""Build the port's structures from another store's state given as
numpy arrays.

A test, or a migration, that holds an SSTable, a DR-tree level or a
Bloom filter of the JAX package as arrays rebuilds the same object
here, so that both packages can be fed identical state.  The cascade's
packed state has its own constructor, ``CascadeState.from_numpy``, and
a model's parameters load with ``load_jax_params``.
"""

from __future__ import annotations

import numpy as np

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
