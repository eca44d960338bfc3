"""The port's logical-axis rules against ``repro.models.sharding``.

For every arch, every shape and both production meshes' axis names
(16 x 16 ('data', 'model'), 2 x 16 x 16 ('pod', 'data', 'model')),
after both packages' ``Transformer(cfg)`` rule resolution and
``adjust_rules_for_shape``, the port's spec of every parameter leaf,
optimizer-state leaf, batch input and cache leaf equals
``tuple(PartitionSpec)`` of the reference's.  The meshes are stand-ins
with the production shapes (no devices): ``AbstractMesh`` for the
reference's shardings, a duck-typed mesh for ``adjust_rules_for_shape``
on both sides.  The dry-run's variants override the rules alike, specs
become DTensor placements as JAX splits dims, and ``constrain`` is the
identity on plain tensors.
"""

from types import SimpleNamespace

import jax
import pytest
import torch
from jax.sharding import AbstractMesh
from torch.distributed.tensor import Replicate, Shard

from repro.configs import ARCHS, SHAPES, get_config
from repro.launch.steps import adjust_rules_for_shape as jadjust
from repro.launch.steps import batch_shardings as jbatch_shardings
from repro.launch.steps import opt_state_shardings as jopt_state_shardings
from repro.models import Transformer as JTransformer
from repro.models import tree_shardings as jtree_shardings
from repro.models.params import is_spec
from repro_torch.configs import SHAPES as TSHAPES
from repro_torch.configs import get_config as tget_config
from repro_torch.launch.dryrun import apply_variants
from repro_torch.launch.mesh import production_shape
from repro_torch.launch.steps import (adjust_rules_for_shape,
                                      batch_shardings, opt_state_shardings)
from repro_torch.models import Transformer, tree_shardings
from repro_torch.models.sharding import (NamedSharding, ShardingRules,
                                         constrain, placements_of)

torch.set_num_threads(1)

MESHES = ("single", "multi")


def meshes(name):
    """(reference jax mesh, reference duck mesh, port duck mesh)."""
    shape, axes = production_shape(multi_pod=name == "multi")
    jmesh = AbstractMesh(shape, axes)
    jduck = SimpleNamespace(axis_names=axes,
                            devices=SimpleNamespace(shape=shape))
    tduck = SimpleNamespace(mesh_dim_names=axes, shape=shape)
    return jmesh, jduck, tduck


def jflat(tree):
    """{path: tuple(spec)} of a tree of jax NamedShardings."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))[0]
    return {"/".join(str(getattr(k, "key", k)) for k in path): tuple(s.spec)
            for path, s in leaves}


def tflat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(tflat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = tuple(v.spec)
    return out


def pad(spec, n):
    """A reference spec as a full tuple (a PartitionSpec may be short)."""
    return tuple(spec) + (None,) * (n - len(spec))


def both(arch, shape_name, mesh_name, variant=None):
    cfg, tcfg = get_config(arch), tget_config(arch)
    shape, tshape = SHAPES[shape_name], TSHAPES[shape_name]
    jmesh, jduck, tduck = meshes(mesh_name)
    jm = JTransformer(cfg)
    tm = Transformer(tcfg, device="meta")
    assert tm.rules.rules == jm.rules.rules
    jadjust(jm, shape, jduck)
    adjust_rules_for_shape(tm, tshape, tduck)
    if variant is not None:
        _jax_variant(jm, variant)
        apply_variants(tm, (variant,), 1)
    return (cfg, shape, jmesh, jm), (tcfg, tshape, tduck, tm)


def _jax_variant(model, v):
    """The reference dry-run's rule overrides for a variant
    (``repro.launch.dryrun.lower_cell``)."""
    if v == "ctxcache":
        prev = model.rules.rules.get("cache_seq") or ()
        model.rules = model.rules.with_overrides(
            cache_dim=None,
            cache_seq=tuple(dict.fromkeys(("model",) + tuple(prev))))
    elif v == "seqpar":
        model.rules = model.rules.with_overrides(act_seq="model")
    elif v == "cponly":
        model.rules = model.rules.with_overrides(
            act_seq="model", q_heads=None, head_dim=None, kv_heads=None,
            mlp=None)
    elif v == "moedecode":
        model.rules = model.rules.with_overrides(expert_in=None,
                                                 expert_d="data")
    elif v == "nofsdp":
        model.rules = model.rules.with_overrides(embed_fsdp=None)


def assert_same(got: dict, want: dict, what):
    assert set(got) == set(want), what
    for k, g in got.items():
        assert g == pad(want[k], len(g)), (what, k, g, want[k])


def check_all(j, t):
    (cfg, shape, jmesh, jm), (tcfg, tshape, tmesh, tm) = j, t
    assert tm.rules.rules == jm.rules.rules
    jspecs, tspecs = jm.param_specs(), tm.param_specs()
    assert_same(tflat(tree_shardings(tspecs, tmesh, tm.rules)),
                jflat(jtree_shardings(jspecs, jmesh, jm.rules)), "params")
    assert_same(tflat(opt_state_shardings(cfg.optimizer, tspecs, tmesh,
                                          tm.rules)),
                jflat(jopt_state_shardings(cfg.optimizer, jspecs, jmesh,
                                           jm.rules)), "opt state")
    assert_same(tflat(batch_shardings(tcfg, tshape, tmesh, tm.rules, tm)),
                jflat(jbatch_shardings(cfg, shape, jmesh, jm.rules, jm)),
                "batch and cache")


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_reference(arch, shape, mesh):
    check_all(*both(arch, shape, mesh))


@pytest.mark.parametrize("variant", ["ctxcache", "seqpar", "cponly",
                                     "moedecode", "nofsdp"])
@pytest.mark.parametrize("arch,shape", [
    ("mixtral-8x7b", "decode_32k"), ("zamba2-7b", "long_500k"),
    ("gemma3-1b", "train_4k"), ("kimi-k2-1t-a32b", "prefill_32k")])
def test_variant_overrides_match_reference(arch, shape, variant):
    for mesh in MESHES:
        check_all(*both(arch, shape, mesh, variant))


def test_spec_drops_absent_axes_and_first_dim_wins():
    rules = ShardingRules().with_overrides(embed="model")
    assert rules.spec(("batch", "embed", "mlp"), ("data", "model")) == \
        ("data", "model", None)
    assert rules.spec(("batch", None), ("pod", "data", "model")) == \
        (("pod", "data"), None)
    assert rules.spec(("layers", "vocab"), ("x",)) == (None, None)


def test_placements_follow_jax_major_to_minor_order():
    names = ("pod", "data", "model")
    assert placements_of((("pod", "data"), None, "model"), names) == (
        Shard(0), Shard(0), Shard(2))
    assert placements_of((None, None), names) == (Replicate(),) * 3
    mesh = SimpleNamespace(mesh_dim_names=("data", "model"))
    assert NamedSharding(mesh, ("model", "data")).placements == (
        Shard(1), Shard(0))


def test_constrain_is_the_identity_on_plain_tensors():
    x = torch.arange(12.0).reshape(3, 4)
    assert constrain(x, ("batch", "embed"), ShardingRules()) is x
