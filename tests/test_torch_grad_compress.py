"""Int8 gradient compression against ``repro.optim.grad_compress``.

``quantize_roundtrip`` is bit-identical to the reference on seeded
inputs of several sizes (partial last blocks, an all-zero block, 2-D
leaves); the reference's two tests (``tests/test_runtime.py``'s
``TestGradCompression``) hold on the port; and ``compressed_psum`` over
a 2-rank ``gloo`` 'pod' group, each rank with its own gradients, equals
the reference's ``shard_map`` with ``in_specs=P('pod')`` on 2 host
devices bit for bit, three steps of error feedback in a row.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import torch_mesh_cells as cells
from repro.optim.grad_compress import compressed_psum as jcompressed_psum
from repro.optim.grad_compress import quantize_roundtrip as jroundtrip
from repro_torch.optim import (make_compressed_crosspod_reduce,
                               quantize_roundtrip)

torch.set_num_threads(1)

SHAPES = [(1,), (255,), (256,), (257,), (1000,), (4109,), (3, 300),
          (2, 128, 3)]
STEPS = 3


def _seeded(shape, seed, scale=3.0):
    x = np.random.default_rng(seed).standard_normal(shape) * scale
    return x.astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_quantize_roundtrip_is_bit_identical(shape):
    x = _seeded(shape, len(shape) * 1000 + shape[-1])
    if x.size >= 512:
        x.reshape(-1)[256:512] = 0.0  # a whole block of zeros: scale 1
    y, r = quantize_roundtrip(torch.from_numpy(x))
    jy, jr = jroundtrip(jnp.asarray(x))
    assert y.dtype == r.dtype == torch.float32
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))


def test_quantize_roundtrip_takes_bf16_in_f32():
    x = torch.from_numpy(_seeded((700,), 7)).to(torch.bfloat16)
    y, r = quantize_roundtrip(x)
    jy, jr = jroundtrip(jnp.asarray(x.float().numpy(), jnp.bfloat16))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))


def test_quantize_roundtrip_error_bounded():
    """``test_runtime.py``'s bound, on the port."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal((1000,)) * 3.0)
                         .astype(np.float32))
    y, resid = quantize_roundtrip(x)
    np.testing.assert_allclose((y + resid).numpy(), x.numpy(), rtol=1e-6)
    assert float(resid.abs().max()) < float(x.abs().max()) / 127.0 + 1e-6


@pytest.fixture(scope="module")
def world():
    grads = [[_seeded((300,), 10 + r), _seeded((4, 70), 20 + r, 0.01)]
             for r in range(2)]
    solo = [np.random.default_rng(1).standard_normal((64,))
            .astype(np.float32)]
    out = cells.run_world(cells.psum_program, (grads, STEPS, solo, 50),
                          world=2, timeout=120)
    return grads, solo, out


def test_compressed_psum_matches_reference_shard_map(world):
    """Two ranks' different gradients: each step's mean (after error
    feedback) equals the reference's on a 2-device 'pod' mesh."""
    grads, _, out = world
    mesh = Mesh(np.array(jax.devices()[:2]), ("pod",))
    f = shard_map(lambda g, e: jcompressed_psum(g, e, "pod"), mesh=mesh,
                  in_specs=(P("pod"), P("pod")),
                  out_specs=(P("pod"), P("pod")), check_rep=False)
    g = [jnp.stack([grads[0][i], grads[1][i]]) for i in range(2)]
    e = [jnp.zeros_like(x) for x in g]
    for step in range(STEPS):
        red, e = f(g, e)
        for i, r in enumerate(red):
            r = np.asarray(r)
            np.testing.assert_array_equal(r[0], r[1])
            np.testing.assert_array_equal(out["reduced"][step][i], r[0])


def test_compressed_psum_matches_exact_with_feedback(world):
    """``test_runtime.py``'s test on a 1-rank 'pod' group: the mean of
    50 compressed reductions with error feedback is the gradient."""
    _, solo, out = world
    np.testing.assert_allclose(out["solo_total"][0] / 50, solo[0],
                               atol=2e-3)


def test_crosspod_reduce_needs_a_pod_axis():
    from types import SimpleNamespace
    assert make_compressed_crosspod_reduce(
        SimpleNamespace(mesh_dim_names=("data", "model"))) is None
