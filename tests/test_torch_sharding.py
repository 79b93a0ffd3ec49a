"""The port's sharding rules and abstract trees against the JAX package's.

`logical_spec` reads only ``mesh.shape``, so the reference's `FakeMesh`
tests port as they are, and every family's `param_specs` and
`cache_specs` at full size are held to the reference's leaf by leaf on
the fake (16, 16) and (2, 16, 16) meshes. The abstract trees (parameters,
the training state under AdamW and SPIN-Shampoo, the model inputs) are
`meta` tensors, held to the reference's ShapeDtypeStructs in shape and
dtype.
"""

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import SHAPES as J_SHAPES, get_arch as j_get_arch
from repro.configs.registry import list_archs
from repro.data import synthetic as j_synthetic
from repro.models import transformer as JT
from repro.parallel.sharding import ShardingRules as JRules, logical_spec as j_logical_spec
from repro.runtime import trainer as j_trainer
from repro_torch import tree
from repro_torch.configs import SHAPES, get_arch
from repro_torch.data.synthetic import input_specs
from repro_torch.launch.mesh import make_worker_mesh, set_mesh
from repro_torch.models import transformer as T
from repro_torch.parallel import (DEFAULT_RULES, PartitionSpec, ShardingRules,
                                  logical_spec, named_sharding, record_specs, shard)
from repro_torch.parallel.collectives import distribute, gather, region_of
from repro_torch.runtime.trainer import TrainConfig, abstract_state

ARCHS = list_archs()
FAKE_MESHES = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16}]
CACHE_SHAPE = (128, 32_768)        # decode_32k: batch, cache length


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape


# ---------------------------------------------------------------------------
# logical_spec: twins of tests/test_costmodel_sharding.py:90-115
# ---------------------------------------------------------------------------


def test_logical_spec_divisibility_drop():
    mesh = FakeMesh({"data": 16, "model": 16})
    rules = ShardingRules()
    # 24 heads don't divide 16 -> replicated
    spec = logical_spec((24, 64), ("heads", None), rules, mesh)
    assert spec == PartitionSpec(None, None) == tuple(JP(None, None))
    spec = logical_spec((32, 64), ("heads", None), rules, mesh)
    assert spec == PartitionSpec("model", None) == tuple(JP("model", None))


def test_logical_spec_conflict_resolution():
    mesh = FakeMesh({"data": 4, "model": 4})
    spec = logical_spec((8, 64, 8, 16), ("batch", "kv_seq", "kv_heads", None),
                        ShardingRules(), mesh)
    assert spec[1] == "model" and spec[2] is None


def test_logical_spec_multi_axis_batch():
    mesh = FakeMesh({"pod": 2, "data": 4, "model": 4})
    spec = logical_spec((16, 128), ("batch", None), ShardingRules(), mesh)
    assert spec[0] == ("pod", "data")
    spec = logical_spec((2, 128), ("batch", None), ShardingRules(), mesh)
    assert spec[0] == "pod"


def test_rules_are_the_references():
    import dataclasses

    ours = dataclasses.asdict(ShardingRules())
    assert ours == dataclasses.asdict(JRules())
    assert DEFAULT_RULES == ShardingRules()
    with pytest.raises(dataclasses.FrozenInstanceError):
        DEFAULT_RULES.batch = None


@pytest.mark.parametrize("shape,logical", [
    ((48, 64), ("heads", "embed_w")), ((7, 3), ("vocab", "ffn")),
    ((64, 32, 16), ("batch", "seq", "ffn")), ((64,), ("none",)),
    ((32, 32), ("experts", "experts")), ((2, 16, 4), ("batch", "kv_seq", "kv_heads"))])
@pytest.mark.parametrize("mesh", FAKE_MESHES, ids=["16x16", "2x16x16"])
def test_logical_spec_sweep_matches_the_reference(shape, logical, mesh):
    want = j_logical_spec(shape, logical, JRules(), FakeMesh(mesh))
    assert logical_spec(shape, logical, ShardingRules(), FakeMesh(mesh)) == tuple(want)


def test_rank_mismatch_raises():
    with pytest.raises(ValueError, match="rank mismatch"):
        logical_spec((4, 4), ("batch",), DEFAULT_RULES, FakeMesh({"data": 2}))


# ---------------------------------------------------------------------------
# Every family at full size: param_specs and cache_specs leaf by leaf
# ---------------------------------------------------------------------------


def _port_leaves(tree_: dict, prefix=()):
    """(path, leaf) of a nested dict whose leaves are specs or tensors."""
    for k in sorted(tree_):
        v = tree_[k]
        if isinstance(v, dict):
            yield from _port_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _ref_leaves(tree_):
    flat = jax.tree_util.tree_flatten_with_path(
        tree_, is_leaf=lambda x: isinstance(x, (JP, jax.ShapeDtypeStruct)))[0]
    return [(tuple(k.key for k in path), leaf) for path, leaf in flat]


@pytest.mark.parametrize("mesh", FAKE_MESHES, ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("name", ARCHS)
def test_param_specs_match_the_reference(name, mesh):
    want = _ref_leaves(JT.param_specs(j_get_arch(name), JRules(), FakeMesh(mesh)))
    got = list(_port_leaves(T.param_specs(get_arch(name), ShardingRules(), FakeMesh(mesh))))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert isinstance(g, PartitionSpec) and g == tuple(w), (path, g, w)


@pytest.mark.parametrize("mesh", FAKE_MESHES, ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("name", ARCHS)
def test_cache_specs_match_the_reference(name, mesh):
    jcfg, cfg = j_get_arch(name), get_arch(name)
    want = JT.cache_specs(jcfg, *CACHE_SHAPE, JRules(), FakeMesh(mesh))
    got = T.cache_specs(cfg, *CACHE_SHAPE, ShardingRules(), FakeMesh(mesh))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == tuple(want[k]), (k, got[k], want[k])


# ---------------------------------------------------------------------------
# Abstract trees: meta tensors against ShapeDtypeStructs
# ---------------------------------------------------------------------------


def _dtype_name(dt) -> str:
    return str(dt).split(".")[-1]


def _same_struct(got, want, what):
    assert tuple(got.shape) == tuple(want.shape), what
    assert _dtype_name(got.dtype) == _dtype_name(jnp.dtype(want.dtype)), what
    assert got.device.type == "meta", what


@pytest.mark.parametrize("name", ARCHS)
def test_abstract_params_and_cache_match_the_reference(name):
    want = _ref_leaves(JT.abstract_params(j_get_arch(name)))
    got = list(_port_leaves(T.abstract_params(get_arch(name))))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        _same_struct(g, w, path)
    jc = JT.abstract_cache(j_get_arch(name), *CACHE_SHAPE)
    c = T.abstract_cache(get_arch(name), *CACHE_SHAPE)
    assert sorted(c) == sorted(jc)
    for k in jc:
        _same_struct(c[k], jc[k], k)


@pytest.mark.parametrize("optimizer", ["adamw", "spin_shampoo"])
@pytest.mark.parametrize("name", ARCHS)
def test_abstract_state_matches_the_reference(name, optimizer):
    from repro.runtime.trainer import TrainConfig as JTrainConfig

    want = jax.tree.leaves(j_trainer.abstract_state(
        j_get_arch(name), JTrainConfig(optimizer=optimizer)))
    got = tree.leaves(abstract_state(get_arch(name), TrainConfig(optimizer=optimizer)))
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _same_struct(g, w, i)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("name", ARCHS)
def test_input_specs_match_the_reference(name, shape):
    want = j_synthetic.input_specs(j_get_arch(name), J_SHAPES[shape])
    got = input_specs(get_arch(name), SHAPES[shape])
    assert sorted(got) == sorted(want)
    for k in want:
        _same_struct(got[k], want[k], k)


# ---------------------------------------------------------------------------
# Layouts on a real mesh
# ---------------------------------------------------------------------------


def test_region_of_takes_a_tuple_of_axes_row_major():
    """("pod", "data") splits a dimension over pod x data with pod
    outermost, as JAX lays it out; distribute and gather round-trip it."""
    mesh = make_worker_mesh((2, 2, 2), ("pod", "data", "model"), devices=["cpu"] * 8)
    for c in mesh.coords():
        pod, data, model = c
        (r0, r1), (c0, c1) = region_of((8, 6), (("pod", "data"), None), mesh, c)
        assert (r0, r1) == ((pod * 2 + data) * 2, (pod * 2 + data + 1) * 2)
        assert (c0, c1) == (0, 6)
        assert region_of((8, 6), (("data", "pod"), "model"), mesh, c)[0][0] == \
            (data * 2 + pod) * 2
    t = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    d = distribute(t, named_sharding(mesh, (8, 6), ("batch", None)).spec, mesh)
    assert d.spec == (("pod", "data"), None)
    assert torch.equal(d.shards[(1, 0, 1)], t[4:6])
    assert torch.equal(gather(d), t)


def test_distribute_refuses_an_indivisible_layout():
    mesh = make_worker_mesh((2, 2), devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="does not split"):
        distribute(torch.zeros(3, 4), ("data", None), mesh)


def test_shard_is_the_identity_and_records_under_a_mesh():
    x = torch.randn(4, 8, 16)
    with record_specs() as recs:
        assert shard(x, "batch", "seq", "ffn") is x          # no mesh: nothing
    assert recs == []
    mesh = make_worker_mesh((2, 4), devices=["cpu"] * 8)
    with set_mesh(mesh), record_specs() as recs:
        assert shard(x, "batch", "seq", "ffn") is x
        assert shard(x, "batch", "seq", "ffn", rules=ShardingRules(ffn=None)) is x
        with pytest.raises(ValueError, match="rank mismatch"):
            shard(x, "batch", "seq")
    assert [(r.op, r.kind, r.spec, r.axes) for r in recs] == [
        ("shard", "logical", ("data", None, "model"), ("batch", "seq", "ffn")),
        ("shard", "logical", ("data", None, None), ("batch", "seq", "ffn"))]
