"""The port's sharding specs (``repro_torch.train.sharding``) against the
JAX package's ``PartitionSpec``s (``repro.train.sharding``), which are
symbolic: no device is needed on either side.

On every architecture of the zoo, at its smoke size and at full size (the
port's meta tensors against ``jax.eval_shape``), stacked and unstacked,
on both pod meshes' dim sizes and without sizes, with and without
``attn_dim0``, under the three plans of ``launch.mesh.PLANS``, each
leaf's spec equals ``tuple(P)`` of the reference's, and so do
``batch_spec`` and ``cache_specs`` on each arch's ``init_cache``.  Then
the port's own additions: ``placements`` on a mesh's named dims, the
shard shapes, and ``launch.mesh``'s plans, node counts and production
meshes against the reference's.
"""

import functools

import jax
import pytest
from torch.distributed.tensor import Replicate, Shard
from torch.utils import _pytree as pytree

from repro import configs as jconfigs
from repro.launch import mesh as jmesh
from repro.models import transformer as jtransformer
from repro.train import sharding as jsharding
from repro_torch import configs as tconfigs
from repro_torch.launch import mesh as tmesh
from repro_torch.models import transformer as ttransformer
from repro_torch.train import sharding as tsharding

ARCHS = list(jconfigs.ARCHITECTURES)
POD_SIZES = [None, {"data": 16, "model": 16},
             {"pod": 2, "data": 16, "model": 16}]
PLAN_KEYS = list(jmesh.PLANS)


def _cfgs(arch: str, size: str):
    jc, tc = jconfigs.get_config(arch), tconfigs.get_config(arch)
    if size == "smoke":
        jc, tc = jconfigs.smoke_variant(jc), tconfigs.smoke_variant(tc)
    return jc, tc


@functools.lru_cache(maxsize=None)
def _trees(arch: str, size: str):
    """(reference shapes, port meta params) of ``arch`` at ``size``."""
    jc, tc = _cfgs(arch, size)
    jshape = jax.eval_shape(lambda k: jtransformer.init_params(jc, k),
                            jax.random.PRNGKey(0))
    return jshape, ttransformer.init_params(tc, 0, "meta")


def _stack(tree, m: int):
    return pytree.tree_map(lambda x: x[None].expand((m,) + x.shape), tree)


def _jax_stack(tree, m: int):
    return jax.tree.map(
        lambda x: jax.ShapeDtypeStruct((m,) + x.shape, x.dtype), tree)


def _flat_specs(specs) -> dict:
    """The reference's specs as tuples, by key path (JAX flattens a dict
    in sorted key order, PyTorch in insertion order)."""
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    return {jax.tree_util.keystr(p): tuple(s) for p, s in flat[0]}


def _port_specs(specs) -> dict:
    flat = pytree.tree_flatten_with_path(
        specs, is_leaf=lambda s: isinstance(s, tuple))
    return {pytree.keystr(p): s for p, s in flat[0]}


def _same_tree_keys(jtree, ttree):
    jkeys = {jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(jtree)[0]}
    tkeys = {pytree.keystr(p) for p, _ in pytree.tree_flatten_with_path(
        ttree)[0]}
    assert jkeys == tkeys


@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_references(arch, size):
    jshape, tmeta = _trees(arch, size)
    _same_tree_keys(jshape, tmeta)
    for key in PLAN_KEYS:
        jplan, tplan = jmesh.PLANS[key], tmesh.PLANS[key]
        for sizes in POD_SIZES:
            for attn_dim0 in (False, True):
                for stacked in (False, True):
                    jt = _jax_stack(jshape, 4) if stacked else jshape
                    tt = _stack(tmeta, 4) if stacked else tmeta
                    want = _flat_specs(jsharding.param_specs(
                        jt, jplan, stacked=stacked, axis_sizes=sizes,
                        attn_dim0=attn_dim0))
                    got = _port_specs(tsharding.param_specs(
                        tt, tplan, stacked=stacked, axis_sizes=sizes,
                        attn_dim0=attn_dim0))
                    assert got == want, (key, sizes, attn_dim0, stacked)


@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_specs_at_every_size_threshold_equal_the_references(arch):
    """FSDP on the production plan at threshold 0 (every 2-D+ leaf) and at
    the default, on the smoke tree, as the reference's own test sets it."""
    jshape, tmeta = _trees(arch, "smoke")
    for min_size in (0, 1 << 16):
        jplan = jsharding.MeshPlan(node_axes=("pod",), fsdp_axes=("data",),
                                   fsdp_min_size=min_size)
        tplan = tsharding.MeshPlan(node_axes=("pod",), fsdp_axes=("data",),
                                   fsdp_min_size=min_size)
        for sizes in POD_SIZES:
            assert _port_specs(tsharding.param_specs(
                tmeta, tplan, axis_sizes=sizes)) == _flat_specs(
                jsharding.param_specs(jshape, jplan, axis_sizes=sizes))


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_batch_specs_equal_the_references(arch):
    jc, tc = _cfgs(arch, "smoke")
    for batch in (1, 8, 32):
        jcache = jax.eval_shape(lambda: jtransformer.init_cache(jc, batch,
                                                                64))
        tcache = ttransformer.init_cache(tc, batch, 64, device="meta")
        _same_tree_keys(jcache, tcache)
        for key in PLAN_KEYS:
            jplan, tplan = jmesh.PLANS[key], tmesh.PLANS[key]
            for sizes in POD_SIZES:
                assert _port_specs(tsharding.cache_specs(
                    tcache, tplan, axis_sizes=sizes)) == _flat_specs(
                    jsharding.cache_specs(jcache, jplan, axis_sizes=sizes))
                for ndim in (2, 3, 4):
                    shape = (4, batch, 16, 8)[:ndim]
                    for stacked in (False, True):
                        assert tsharding.batch_spec(
                            tplan, ndim, stacked=stacked, shape=shape,
                            axis_sizes=sizes) == tuple(jsharding.batch_spec(
                                jplan, ndim, stacked=stacked, shape=shape,
                                axis_sizes=sizes))
    jshape, tmeta = _trees(arch, "smoke")
    for key in PLAN_KEYS:
        assert _port_specs(tsharding.stacked_specs(
            _stack(tmeta, 2), tmesh.PLANS[key])) == _flat_specs(
            jsharding.stacked_specs(_jax_stack(jshape, 2),
                                    jmesh.PLANS[key]))


class _Mesh:
    """What ``placements`` reads of a ``DeviceMesh``: its dim names."""

    def __init__(self, *names):
        self.mesh_dim_names = names


def test_placements_shard_each_named_dim():
    mesh = _Mesh("pod", "data", "model")
    assert tsharding.placements((None, "model"), mesh) == (
        Replicate(), Replicate(), Shard(1))
    assert tsharding.placements(("pod", "data", "model"), mesh) == (
        Shard(0), Shard(1), Shard(2))
    assert tsharding.placements((("pod", "data"), None), mesh) == (
        Shard(0), Shard(0), Replicate())
    assert tsharding.placements((), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="'nodes'"):
        tsharding.placements(("nodes",), _Mesh("data", "model"))


def test_shard_shape_rounds_up_and_splits_over_products():
    sizes = {"pod": 2, "data": 16, "model": 16}
    assert tsharding.shard_shape((32000, 2560), ("model", None), sizes) == \
        (2000, 2560)
    assert tsharding.shard_shape((51865, 512), ("model", "data"), sizes) == \
        (3242, 32)
    assert tsharding.shard_shape((64, 8), (("pod", "data"), None), sizes) == \
        (2, 8)
    assert tsharding.spec_axes(("pod", "data")) == ("pod", "data")
    assert tsharding.spec_axes(None) == ()


def test_mesh_plans_and_production_meshes_are_the_references():
    assert {k: (v.node_axes, v.model_axis, v.fsdp_axes, v.fsdp_min_size)
            for k, v in tmesh.PLANS.items()} == \
        {k: (v.node_axes, v.model_axis, v.fsdp_axes, v.fsdp_min_size)
         for k, v in jmesh.PLANS.items()}
    for multi in (False, True):
        for mapping in ("auto", "faithful") + (("production",) if multi
                                               else ()):
            tp = tmesh.default_plan(multi, mapping)
            jp = jmesh.default_plan(multi, mapping)
            assert (tp.node_axes, tp.fsdp_axes) == (jp.node_axes,
                                                    jp.fsdp_axes)
            shape = tmesh.make_production_mesh(multi_pod=multi)
            assert shape.shape == ({"pod": 2, "data": 16, "model": 16}
                                   if multi else {"data": 16, "model": 16})
            assert shape.size == (512 if multi else 256)
            # node_count over the reference's mesh shape, without devices
            fake = type("M", (), {"shape": shape.shape})()
            assert tmesh.node_count(shape, tp) == \
                jmesh.node_count(fake, jp)


def test_make_mesh_needs_a_group_and_the_worlds_size():
    with pytest.raises(ValueError, match="spmd.spawn"):
        tmesh.make_mesh((2, 2), ("data", "model"), "cpu")
    with pytest.raises(ValueError, match="length"):
        tmesh.make_mesh((2, 2), ("data",), "cpu")
