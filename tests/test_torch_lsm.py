"""Bare ``repro_torch.lsm.LSMTree``s against ``repro.lsm.LSMTree`` across
all five range-delete strategies.

The same op stream, made with numpy from a seed, drives both trees:
lookup results, range scans, every ``IOStats`` snapshot, the flush
points (memtable size after every op) and the level shapes must be
equal.  The merge-rank hook (``compaction_rank_fn``) is exercised with
the port's plain merge-rank version, which must not change anything.
"""

import numpy as np
import pytest
import torch

from repro.lsm import LSMConfig as JLSMConfig
from repro.lsm import LSMTree as JLSMTree
from repro.core import GloranConfig as JGloranConfig
from repro.core import LSMDRTreeConfig as JIndexConfig
from repro.core import RAEConfig as JRAEConfig
from repro_torch.carry import sstable_from_arrays
from repro_torch.core import GloranConfig, LSMDRTreeConfig, RAEConfig
from repro_torch.kernels.merge import merge_ranks
from repro_torch.lsm import LSMConfig, LSMTree, STRATEGIES

torch.set_num_threads(1)

UNIVERSE = 1 << 16


def make(side, strategy, rank_hook=False):
    L, G, D, R, Tree = ((LSMConfig, GloranConfig, LSMDRTreeConfig,
                         RAEConfig, LSMTree) if side == "torch" else
                        (JLSMConfig, JGloranConfig, JIndexConfig,
                         JRAEConfig, JLSMTree))
    cfg = L(buffer_capacity=96, size_ratio=3, key_size=16, value_size=48,
            block_size=512, key_universe=UNIVERSE)
    gl = G(index=D(buffer_capacity=48, size_ratio=3, key_size=16,
                   block_size=512),
           eve=R(capacity=256, key_universe=UNIVERSE))
    tree = Tree(cfg, strategy=strategy,
                gloran_config=gl if strategy == "gloran" else None)
    if rank_hook:
        tree.compaction_rank_fn = lambda a, b: merge_ranks(
            a.astype(np.uint32), b.astype(np.uint32), "cpu")
    return tree


def shape(tree):
    return ([len(l) if l is not None else 0 for l in tree.levels],
            len(tree.mem), tree.seq)


def replay(tree, seed=0):
    """Returns everything observable after every op."""
    rng = np.random.default_rng(seed)
    trace = []
    for r in range(7):
        k = rng.integers(0, 3000, 160).astype(np.uint64)
        tree.put_batch(k, k * np.uint64(5) + np.uint64(r))
        trace.append(shape(tree))
        tree.delete_batch(rng.integers(0, 3000, 20).astype(np.uint64))
        trace.append(shape(tree))
        for _ in range(5):
            lo = int(rng.integers(0, 2950))
            tree.range_delete(lo, lo + int(rng.integers(1, 40)))
            trace.append(shape(tree))
        q = rng.integers(0, 3100, 400).astype(np.uint64)
        found, vals = tree.get_batch(q)
        trace.append((found.tolist(), vals[found].tolist()))
        lo = int(rng.integers(0, 2800))
        keys, vals = tree.range_scan(lo, lo + 200)
        trace.append((keys.tolist(), vals.tolist()))
        trace.append(tree.io.snapshot())
    tree.flush()
    trace.append((shape(tree), tree.io.snapshot()))
    return trace


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_tree_matches_reference(strategy):
    ref = replay(make("jax", strategy))
    assert replay(make("torch", strategy)) == ref
    assert replay(make("torch", strategy, rank_hook=True)) == ref


def test_sstable_carried_from_reference_arrays():
    """A run rebuilt from the reference's columns and seed answers and
    charges exactly like the reference's run."""
    ref_tree = make("jax", "decomp")
    replay(ref_tree)
    run = next(l for l in ref_tree.levels if l is not None and len(l))
    port = sstable_from_arrays(run.keys, run.seqs, run.types, run.vals,
                               make("torch", "decomp").config, seed=run.seed)
    np.testing.assert_array_equal(port.bloom.words, run.bloom.words)
    q = np.random.default_rng(1).integers(0, 3100, 500).astype(np.uint64)
    for a, b in zip(port.get_batch(q), run.get_batch(q)):
        np.testing.assert_array_equal(a, b)
