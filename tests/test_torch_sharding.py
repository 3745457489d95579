"""The PyTorch port's sharding plan (`mxtpu_torch/sharding/`: `plan.py`,
`reshard.py`, `zero1.py`'s accounting, `mx.shard`) and the
transformer's ZeRO-1 layout against the JAX package's (`mxtpu/sharding/`,
`mxtpu/parallel/transformer.py`) on the conftest's 8 CPU devices; the
port's meshes repeat the CPU device.
"""
import numpy as np
import pytest
import torch

import jax
from jax.sharding import NamedSharding

import mxtpu.parallel as jpar
import mxtpu.sharding as jshard
from mxtpu.parallel import transformer as jtf
import mxtpu_torch as tmx
from mxtpu_torch import sharding as tshard
from mxtpu_torch.base import MXNetError
from mxtpu_torch.ndarray import NDArray
from mxtpu_torch.parallel import mesh as tmesh
from mxtpu_torch.parallel import spmd
from mxtpu_torch.parallel import transformer as ttf
from mxtpu_torch.parallel.spmd import P

torch.set_num_threads(1)

CPU = torch.device("cpu")
CFG = dict(vocab=32, d_model=64, n_heads=4, n_layers=4, d_ff=128,
           max_len=32, dtype="float32")


def _meshes(**axes):
    shape = {a: 1 for a in ("dp", "pp", "tp", "sp", "ep")}
    shape.update(axes)
    n = int(np.prod(list(shape.values())))
    return (jpar.create_mesh(shape, devices=jax.devices()[:n]),
            tmesh.create_mesh(shape, devices=[CPU] * n))


def _plans(jm, tm, **kw):
    specs = jtf.param_specs(jtf.TransformerConfig(**CFG))
    tspecs = ttf.param_specs(ttf.TransformerConfig(**CFG))
    return (jshard.ShardingPlan(mesh=jm, param_specs=specs, **kw),
            tshard.ShardingPlan(mesh=tm, param_specs=tspecs, **kw))


def _spec(s):
    return tuple(tuple(p) if isinstance(p, (tuple, list)) else p for p in s)


@pytest.mark.parametrize("axes", [dict(dp=2, tp=2, sp=2), dict(dp=8),
                                  dict(dp=2, pp=2, tp=2), dict(dp=4, tp=2)])
def test_plan_specs_and_slices_match_jax(axes):
    jm, tm = _meshes(**axes)
    jp, tp = _plans(jm, tm, min_shard_elems=64)
    shapes = ttf.param_shapes(ttf.TransformerConfig(**CFG), tm.shape["pp"])
    assert tp.num_shards == jp.num_shards == axes["dp"]
    for name, shape in shapes.items():
        dim = tp.shard_dim(name, shape)
        assert dim == jp.shard_dim(name, shape), name
        assert _spec(tp.opt_state_spec(name, shape)) == \
            _spec(jp.opt_state_spec(name, shape)), name
        assert _spec(tp.spec_for(name, shape)) == \
            _spec(jp.spec_for(name, shape)), name
        if dim is not None:
            for rank in range(tp.num_shards):
                assert tp.shard_slice(shape, dim, rank) == \
                    jp.shard_slice(shape, dim, rank)
    assert tp.describe() == jp.describe()
    assert repr(tp) == repr(jp)


def test_plan_modes_env_and_scopes_match_jax(monkeypatch):
    for kw in (dict(num_shards=4), dict(num_shards=4, shard_data=True),
               dict(num_shards=3, min_shard_elems=1),
               dict(shard_optimizer_state=False, num_shards=2),
               dict(name="x")):
        j, t = jshard.ShardingPlan(**kw), tshard.ShardingPlan(**kw)
        assert t.describe() == j.describe()
        for name, shape in (("w", (8, 4096)), ("b", (6,)), ("data", (8, 3)),
                            ("odd", (3, 5000))):
            assert t.shard_dim(name, shape) == j.shard_dim(name, shape)
            assert _spec(t.spec_for(name)) == _spec(j.spec_for(name))
    p = tshard.ShardingPlan()
    assert not p.resolved_explicitly and p.num_shards == 1
    assert p.resolved(4).num_shards == 4 and p.num_shards == 1
    pinned = tshard.ShardingPlan(num_shards=2)
    assert pinned.resolved(2) is pinned
    with pytest.raises(MXNetError, match="pinned to 2 shards"):
        pinned.resolved(3)
    with pytest.raises(MXNetError, match="out of range"):
        pinned.shard_slice((4,), 0, 2)
    with pytest.raises(MXNetError, match="named_sharding"):
        pinned.named_sharding(P())
    # the scopes nest; None masks an outer plan
    assert tshard.current_plan() is None and not tshard.shard_requested()
    with p.activate():
        assert tshard.current_plan() is p
        with tshard.plan_scope(None):
            assert tshard.current_plan() is None
        assert tshard.shard_requested()
    # the environment, read as the JAX package reads it
    monkeypatch.setenv("MXTPU_SHARD_MIN_SIZE", "16")
    monkeypatch.setenv("MXTPU_SHARD_OPT_STATE", "off")
    assert tshard.default_min_shard_elems() == \
        jshard.default_min_shard_elems() == 16
    assert tshard.opt_state_sharding_default() is \
        jshard.opt_state_sharding_default() is False
    monkeypatch.setenv("MXTPU_SHARD", "zero1")
    env = tshard.current_plan()
    assert env is not None and env.name == "env"
    assert tshard.current_plan() is env
    assert tshard.auto_plan(4).num_shards == 4
    assert tmx.shard is tmx.sharding


def _by_coord(arr, jm):
    """A JAX array's shards by mesh coordinate."""
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    coord_of = {int(ids[c]): c for c in np.ndindex(*ids.shape)}
    return {coord_of[sh.device.id]: np.asarray(sh.data)
            for sh in arr.addressable_shards}


@pytest.mark.parametrize("kind", ["params", "opt_state"])
def test_reshard_between_two_plans_matches_jax(kind):
    """Train layout (dp 4 x tp 2, ZeRO-1) to serve layout (dp 2 x tp 4)
    and to no mesh: every coordinate's block is the one JAX places on
    that coordinate's device."""
    jm_a, tm_a = _meshes(dp=4, tp=2)
    jm_b, tm_b = _meshes(dp=2, tp=4)
    ja, ta = _plans(jm_a, tm_a, min_shard_elems=64)
    jb, tb = _plans(jm_b, tm_b, min_shard_elems=64)
    rng = np.random.RandomState(0)
    shapes = jtf.param_shapes(jtf.TransformerConfig(**CFG), 1)
    tree = {n: rng.normal(size=s).astype(np.float32)
            for n, s in shapes.items()}
    spec_a = ja.spec_for if kind == "params" else ja.opt_state_spec
    jtree = {n: jax.device_put(x, NamedSharding(
        jm_a, spec_a(n, x.shape))) for n, x in tree.items()}
    ttree = tshard.reshard(tree, ta, kind=kind)
    got = tshard.reshard(ttree, tb, plan_a=ta, kind=kind, label="serve")
    want = jshard.reshard(jtree, jb, plan_a=ja, kind=kind, label="serve")
    for name in tree:
        assert isinstance(got[name], spmd.Sharded)
        jshards = _by_coord(want[name], jm_b)
        for coord, t in zip(tm_b.coords, got[name].shards):
            np.testing.assert_array_equal(t.numpy(), jshards[coord])
    # a plan without a mesh gathers each leaf into one tensor
    flat = tshard.reshard(got, tshard.ShardingPlan(num_shards=1), kind=kind)
    jflat = jshard.reshard(want, jshard.ShardingPlan(num_shards=1),
                           kind=kind)
    for name in tree:
        np.testing.assert_array_equal(flat[name].numpy(),
                                      np.asarray(jflat[name]))
    # one leaf, an NDArray, comes back as itself
    one = tshard.reshard(NDArray(torch.ones(4)),
                         tshard.ShardingPlan(num_shards=1))
    assert isinstance(one, NDArray) and one.asnumpy().tolist() == [1.0] * 4
    with pytest.raises(MXNetError, match="kind"):
        tshard.reshard(tree, tb, kind="grads")


def test_transformer_zero1_layout_matches_jax():
    for axes in (dict(dp=2, tp=2, sp=2), dict(dp=2, pp=2, tp=2),
                 dict(dp=8), dict(dp=2, tp=2, ep=2)):
        jm, tm = _meshes(**axes)
        for cfg in (CFG, dict(CFG, d_model=128, d_ff=512, vocab=256)):
            jc, tc = jtf.TransformerConfig(**cfg), \
                ttf.TransformerConfig(**cfg)
            assert ttf._zero1_dims(tc, tm) == jtf._zero1_dims(jc, jm)
            assert {n: _spec(s) for n, s in
                    ttf._opt_state_specs(tc, tm).items()} == \
                {n: _spec(s) for n, s in jtf._opt_state_specs(jc, jm).items()}
            assert ttf._grad_psum_axes(tc) == jtf._grad_psum_axes(jc)
            assert ttf._plan_for_mesh(tc, tm).describe() == \
                jtf._plan_for_mesh(jc, jm).describe()


def test_state_accounting_and_what_waits():
    _, tm = _meshes(dp=4)
    s = spmd.shard(np.zeros((8, 6), np.float32), tm, P("dp"))
    tree = {"a": s, "b": [torch.zeros(3), NDArray(torch.zeros(2))],
            "c": np.zeros(5, np.float64), "d": None}
    assert tshard.tree_nbytes(tree) == 8 * 6 * 4 + 3 * 4 + 2 * 4 + 5 * 8
    assert jshard.tree_nbytes({"c": np.zeros(5, np.float64)}) == 40

    class Upd:
        states = {0: torch.zeros(10)}

    assert tshard.state_nbytes(Upd()) == 40
    with pytest.raises(MXNetError, match="A15c"):
        tshard.ZeRO1Updater(None, 2)
    with pytest.raises(MXNetError, match="A18"):
        tshard.hbm_report(Upd())
