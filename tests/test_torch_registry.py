"""``repro_torch.engine.registry`` against ``repro.engine.registry``.

Both registries pack the same tree state (two trees driven by one op
stream): every pack array and offset, the level slots, the upload-byte
ledger and the per-level device columns must be equal, and a moved
GLORAN index epoch or a flushed run must re-pack on both sides alike.
"""

import numpy as np
import pytest
import torch

from repro.engine.registry import DeviceFilterRegistry as JRegistry
from repro.engine.stats import KernelCounters as JCounters
from repro_torch.engine.registry import DeviceFilterRegistry
from repro_torch.engine.stats import KernelCounters
from repro_torch.kernels.cascade import CascadeState
from repro_torch.kernels.u32 import to_numpy

from test_torch_lsm import make

torch.set_num_threads(1)

U32 = ("lkeys", "lseqs", "words", "mbits", "seeds", "glo_lo", "glo_hi",
       "glo_smin", "glo_smax")
I32 = ("key_off", "key_cnt", "word_off", "gl_off", "gl_cnt")
GL = ("glo_lo", "glo_hi", "glo_smin", "glo_smax", "gl_off", "gl_cnt")


def drive(tree, rng, rounds):
    for _ in range(rounds):
        k = rng.integers(0, 3000, 300).astype(np.uint64)
        tree.put_batch(k, k + np.uint64(1))
        lo = rng.integers(0, 2950, 30).astype(np.uint64)
        tree.range_delete_arrays(lo, lo + rng.integers(1, 40, 30)
                                 .astype(np.uint64))


def pair(rounds=6, seed=0):
    trees = []
    for side in ("jax", "torch"):
        t = make(side, "gloran")
        drive(t, np.random.default_rng(seed), rounds)
        trees.append(t)
    return trees


def assert_same_view(jv, tv):
    js, ts = jv.state, tv.state
    assert (ts.L, ts.H, ts.G) == (js.L, js.H, js.G)
    for f in U32 + I32:
        if f in GL and not js.G:
            assert getattr(ts, f).numel() == 0  # no GLORAN columns
            continue
        np.testing.assert_array_equal(
            to_numpy(getattr(ts, f), np.uint32 if f in U32 else np.int32),
            np.asarray(getattr(js, f)), err_msg=f)
    np.testing.assert_array_equal(tv.slots, jv.slots)
    assert tv.has_gloran == jv.has_gloran


@pytest.mark.parametrize("rounds", (2, 6))
def test_pack_matches_reference(rounds):
    jt, tt = pair(rounds)
    jreg, treg = JRegistry(JCounters()), DeviceFilterRegistry(
        "cpu", KernelCounters())
    jv, tv = jreg.view(jt), treg.view(tt)
    assert_same_view(jv, tv)
    assert treg.counters.upload_bytes == jreg.counters.upload_bytes > 0
    assert treg.counters.upload_bytes_by_device == {
        "cpu": jreg.counters.upload_bytes}
    # The same state carried across as numpy arrays.
    carried = CascadeState.from_numpy(
        **{f: np.asarray(getattr(jv.state, f)) for f in U32 + I32})
    for f in U32 + I32:
        assert torch.equal(getattr(carried, f), getattr(tv.state, f)), f


def test_epoch_and_flush_invalidate_like_reference():
    jt, tt = pair(6)
    jreg, treg = JRegistry(JCounters()), DeviceFilterRegistry(
        "cpu", KernelCounters())
    v0 = treg.view(tt)
    jreg.view(jt)
    assert treg.view(tt) is v0 and treg.counters.cascade_packs == 1
    epoch = tt.gloran.index_epoch
    rng = np.random.default_rng(9)
    for t in (jt, tt):  # enough range deletes to flush the index buffer
        lo = rng.integers(0, 2950, 200).astype(np.uint64)
        t.range_delete_arrays(lo, lo + np.uint64(7))
        rng = np.random.default_rng(9)
    assert tt.gloran.index_epoch != epoch
    v1, jv1 = treg.view(tt), jreg.view(jt)
    assert v1 is not v0 and treg.counters.cascade_packs == 2
    assert_same_view(jv1, v1)
    for t in (jt, tt):
        t.flush()
    v2, jv2 = treg.view(tt), jreg.view(jt)
    assert_same_view(jv2, v2)
    assert treg.counters.snapshot()["upload_bytes"] == \
        jreg.counters.upload_bytes
    assert treg.counters.cascade_packs == jreg.counters.cascade_packs == 3


def test_per_level_columns_match_reference():
    jt, tt = pair(6)
    jreg, treg = JRegistry(JCounters()), DeviceFilterRegistry(
        "cpu", KernelCounters())
    for jl, tl in zip(jt.levels, tt.levels):
        if jl is None or not len(jl):
            continue
        np.testing.assert_array_equal(
            to_numpy(treg.bloom_words(tl)), np.asarray(jreg.bloom_words(jl)))
    jlive = jt.gloran.level_views()
    tlive = tt.gloran.level_views()
    assert len(tlive) == len(jlive) > 0
    for jg, tg in zip(jlive, tlive):
        for a, b in zip(treg.gl_columns(tg, tlive),
                        jreg.gl_columns(jg, jlive)):
            np.testing.assert_array_equal(to_numpy(a), np.asarray(b))
    assert treg.counters.upload_bytes == jreg.counters.upload_bytes
