"""Build the port's structures from another store's state given as
numpy arrays.

A test, or a migration, that holds an SSTable, a DR-tree level or a
Bloom filter of the JAX package as arrays rebuilds the same object
here, so that both packages can be fed identical state.  The cascade's
packed state has its own constructor, ``CascadeState.from_numpy``.
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
