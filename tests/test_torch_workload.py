"""``repro_torch.baselines`` and ``repro_torch.data`` against the JAX
package's ``repro.baselines`` and ``repro.data``.

Both are host numpy over the LSM-tree, so the same seed must give the
same op stream and the same simulated I/O: ``run_workload``'s op and
I/O counts, per-type ledgers and byte sizes, and a final ``get_batch``,
are equal for every strategy under both key distributions.  A
``VersionedSampleStore`` publish / purge / get / ``scan_version`` run
answers the same in both packages.
"""

import numpy as np
import pytest
import torch

from repro.baselines import WorkloadMix as JMix
from repro.baselines import make_tree as jmake_tree
from repro.baselines import run_workload as jrun
from repro.baselines import zipf_keys as jzipf
from repro.data import VersionedSampleStore as JStore
from repro_torch.baselines import (WorkloadMix, make_tree, run_workload,
                                   zipf_keys)
from repro_torch.data import VersionedSampleStore

torch.set_num_threads(1)

STRATEGIES = ("decomp", "lookup_delete", "scan_delete", "lrr", "gloran")
U = 1 << 18
TREE = dict(buffer_capacity=512, index_buffer=64, eve_capacity=4096,
            universe=U)
MIX = dict(lookup=0.45, update=0.35, range_delete=0.1, range_lookup=0.1,
           range_delete_len=64, range_lookup_len=50, universe=U)


def preload(tree, n, seed=0):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, U, size=n).astype(np.uint64)
    tree.put_batch(keys, keys * np.uint64(31) + np.uint64(7))


@pytest.mark.parametrize("dist", ["uniform", "zipfian"])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_run_workload_matches_jax(strategy, dist):
    out = []
    for mk, mix_cls, run in ((jmake_tree, JMix, jrun),
                             (make_tree, WorkloadMix, run_workload)):
        tree = mk(strategy, **TREE)
        preload(tree, 6000)
        res = run(tree, 2500, mix_cls(distribution=dist, **MIX), seed=3,
                  batch=128)
        probe = np.random.default_rng(5).integers(0, U, 4096)
        found, vals = tree.get_batch(probe.astype(np.uint64))
        out.append((res, np.asarray(found), np.asarray(vals)))
    (jres, jfound, jvals), (res, found, vals) = out
    for f in ("n_ops", "io_reads", "io_writes", "io_by_type",
              "counts_by_type", "disk_bytes", "memory_bytes"):
        assert getattr(res, f) == getattr(jres, f), f
    assert res.counts_by_type["range_delete"] > 0
    assert res.counts_by_type["range_lookup"] > 0
    assert found.any() and not found.all()
    np.testing.assert_array_equal(found, jfound)
    np.testing.assert_array_equal(vals[found], jvals[jfound])


def test_zipf_keys_match_jax():
    for s in (0.99, 1.2):
        got = zipf_keys(np.random.default_rng(1), 5000, U, s)
        want = jzipf(np.random.default_rng(1), 5000, U, s)
        assert got.dtype == want.dtype == np.uint64
        np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) < 5000  # skewed: hot keys repeat


@pytest.mark.parametrize("strategy", ["gloran", "lrr", "decomp"])
def test_versioned_store_matches_jax(strategy):
    stores = [JStore(strategy=strategy), VersionedSampleStore(strategy)]
    rng = np.random.default_rng(2)
    for v in range(5):
        ids = rng.permutation(3000)[:2000]
        for st in stores:
            st.publish(v, ids, ids * (v + 1) + 7)
    for st in stores:
        st.purge_version(1)
        st.purge_version(3)
    jst, st = stores
    assert st.live_versions == jst.live_versions == {0, 2, 4}
    for v in range(5):
        ids = np.arange(3000)
        f, vals = st.get_batch(v, ids)
        jf, jvals = jst.get_batch(v, ids)
        np.testing.assert_array_equal(np.asarray(f), np.asarray(jf))
        np.testing.assert_array_equal(np.asarray(vals)[f],
                                      np.asarray(jvals)[jf])
        assert np.asarray(f).any() == (v in (0, 2, 4))
        keys, vals = st.scan_version(v)
        jkeys, jvals = jst.scan_version(v)
        np.testing.assert_array_equal(keys, jkeys)
        np.testing.assert_array_equal(vals, jvals)
        assert st.get(v, int(ids[0])) == jst.get(v, int(ids[0]))
    assert st.tree.io.reads == jst.tree.io.reads
    assert st.tree.io.writes == jst.tree.io.writes
