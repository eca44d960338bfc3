"""``repro_torch.models.moe`` against ``repro.models.moe``.

The same seeded numpy inputs go through both packages' ``moe_ffn`` and
``moe_aux_loss`` in f32, held to atol/rtol 1e-5 (the sums run in other
orders).  A router biased toward one expert overfills it, so the
capacity drops pairs: both packages drop the same (token, expert)
pairs, and exactly the tokens whose output the drop changes in the JAX
package.  The capacity expression is pinned by value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.moe import moe_aux_loss as jaux
from repro.models.moe import moe_ffn as jmoe
from repro.models.sharding import ShardingRules
from repro_torch.models import moe_aux_loss, moe_ffn
from repro_torch.models.moe import capacity, dispatch_order, route

torch.set_num_threads(1)

B, S, D, F = 2, 16, 32, 48


def weights(rng, e, shared):
    w = {"router": rng.standard_normal((D, e)) * 0.3,
         "w_gate": rng.standard_normal((e, D, F)) * 0.1,
         "w_up": rng.standard_normal((e, D, F)) * 0.1,
         "w_down": rng.standard_normal((e, F, D)) * 0.1}
    if shared:
        w["shared"] = {"w_gate": rng.standard_normal((D, F)) * 0.1,
                       "w_up": rng.standard_normal((D, F)) * 0.1,
                       "w_down": rng.standard_normal((F, D)) * 0.1}
    return jax.tree.map(lambda a: a.astype(np.float32), w)


def run_both(x, w, top_k, cf):
    jw = jax.tree.map(jnp.asarray, w)
    tw = jax.tree.map(torch.from_numpy, w)
    want = jmoe(jnp.asarray(x), jw["router"], jw["w_gate"], jw["w_up"],
                jw["w_down"], top_k=top_k, capacity_factor=cf,
                rules=ShardingRules(), shared=jw.get("shared"))
    got = moe_ffn(torch.from_numpy(x), tw["router"], tw["w_gate"],
                  tw["w_up"], tw["w_down"], top_k=top_k,
                  capacity_factor=cf, shared=tw.get("shared"))
    return got, np.asarray(want)


@pytest.mark.parametrize("e,top_k,shared", [(8, 2, False), (16, 8, True),
                                            (4, 1, False)])
def test_moe_ffn_and_aux_loss_match_jax(e, top_k, shared):
    rng = np.random.default_rng(e * 10 + top_k)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    w = weights(rng, e, shared)
    got, want = run_both(x, w, top_k, 1.25)
    assert got.shape == (B, S, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    loss = moe_aux_loss(torch.from_numpy(x), torch.from_numpy(w["router"]),
                        top_k=top_k)
    jloss = jaux(jnp.asarray(x), jnp.asarray(w["router"]), top_k=top_k)
    np.testing.assert_allclose(float(loss), float(jloss), atol=1e-5,
                               rtol=1e-5)


def jax_dropped(x, router, top_k, cf):
    """The (token, expert) pairs the JAX package's ``moe_ffn`` drops, by
    its own steps (``lax.top_k``, stable ``argsort``, rank, capacity)."""
    t, e = x.shape[0] * x.shape[1], router.shape[-1]
    logits = jnp.einsum("td,de->te", jnp.asarray(x.reshape(t, -1)),
                        jnp.asarray(router))
    _, top_idx = jax.lax.top_k(logits, top_k)
    flat_e = top_idx.reshape(-1)
    order = jnp.argsort(flat_e)
    counts = jnp.zeros((e,), jnp.int32).at[flat_e].add(1)
    offsets = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                               jnp.cumsum(counts)[:-1]])
    rank = jnp.arange(t * top_k) - offsets[flat_e[order]]
    cap = int(max(8, -(-(t * top_k) // e * cf)))
    cap = -(-cap // 8) * 8
    drop = np.asarray(rank >= cap)
    tok = np.asarray(order)[drop] // top_k
    return {(int(a), int(b)) for a, b in
            zip(tok, np.asarray(flat_e[order])[drop])}


def port_dropped(x, router, top_k, cf):
    t, e = x.shape[0] * x.shape[1], router.shape[-1]
    _, _, top_idx = route(torch.from_numpy(x.reshape(t, -1)),
                          torch.from_numpy(router), top_k)
    order, e_sorted, rank = dispatch_order(top_idx, e)
    drop = rank >= capacity(t, top_k, e, cf)
    return {(int(a), int(b)) for a, b in
            zip(order[drop] // top_k, e_sorted[drop])}


@pytest.mark.parametrize("e,top_k", [(8, 2), (16, 8)])
def test_biased_router_drops_the_same_pairs(e, top_k):
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((B, S, D)) + 0.5).astype(np.float32)
    w = weights(rng, e, False)
    w["router"][:, 0] += 0.5  # every token prefers expert 0
    cf = 1.0
    want_drop = jax_dropped(x, w["router"], top_k, cf)
    assert len(want_drop) > 8, "the bias must overfill expert 0"
    assert port_dropped(x, w["router"], top_k, cf) == want_drop
    got, want = run_both(x, w, top_k, cf)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    # The drops show in the JAX package's output: exactly the tokens
    # with a dropped pair differ from an uncapped run (a capacity factor
    # of e holds every pair) by more than rounding.
    _, uncapped = run_both(x, w, top_k, float(e))
    moved = np.abs(want - uncapped).reshape(B * S, D).max(1) > 1e-4
    assert set(np.flatnonzero(moved)) == {tok for tok, _ in want_drop}


@pytest.mark.parametrize("t,k,e,cf,cap", [
    (16, 2, 8, 1.25, 8),  # below the floor of 8
    (256, 2, 8, 1.25, 80),
    (8192, 2, 8, 1.25, 2560),  # mixtral's bf16 prefill, 4 x 2048
    (1000, 8, 384, 1.25, 32),  # 26.25 -> 26 -> 32
    (5, 1, 4, 10.0, 24),  # ceil(5 / 4) * 10, not (5 // 4) * 10
    (100, 2, 3, 1.1, 80),  # ceil(200 / 3) * 1.1 = 73.7 -> 80
])
def test_capacity_expression(t, k, e, cf, cap):
    assert capacity(t, k, e, cf) == cap
    assert capacity(t, k, e, cf) == -(-int(max(
        8, -(-(t * k) // e * cf))) // 8) * 8
