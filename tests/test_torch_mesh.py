"""The PyTorch port's meshes (`mxtpu_torch/parallel/mesh.py`), its
one-controller SPMD machinery (`parallel/spmd.py`) and its eager
collectives (`parallel/collectives.py`) against the JAX package's
(`mxtpu/parallel/mesh.py`, `collectives.py`) on the conftest's 8 CPU
devices; the port's meshes repeat the CPU device (`[cpu] * n`).  Inputs
come from numpy; the collectives' results are exact in both packages.
"""
import numpy as np
import pytest
import torch

import jax

import mxtpu.parallel as jpar
from mxtpu.base import MXNetError as JaxMXNetError
from mxtpu_torch.base import MXNetError
from mxtpu_torch.parallel import collectives as tcol
from mxtpu_torch.parallel import mesh as tmesh
from mxtpu_torch.parallel import spmd
from mxtpu_torch.parallel.spmd import P
from mxtpu_torch.sharding import ShardingPlan, plan_scope

torch.set_num_threads(1)

CPU = torch.device("cpu")
AXES = ("dp", "pp", "tp", "sp", "ep")


def _full(**axes):
    shape = {a: 1 for a in AXES}
    shape.update(axes)
    return shape


def _meshes(**axes):
    """The JAX package's mesh over the first n CPU devices and the port's
    over [cpu] * n."""
    shape = _full(**axes)
    n = int(np.prod(list(shape.values())))
    return (jpar.create_mesh(shape, devices=jax.devices()[:n]),
            tmesh.create_mesh(shape, devices=[CPU] * n))


# -- the mesh -----------------------------------------------------------------

@pytest.mark.parametrize("n,kw", [(8, {}), (8, dict(tp=2)),
                                  (8, dict(tp=2, pp=2)),
                                  (8, dict(sp=4, ep=2)), (1, {})])
def test_default_mesh_shape_matches_jax(n, kw):
    assert tmesh.default_mesh_shape(n, **kw) == \
        jpar.default_mesh_shape(n, **kw)


def test_default_mesh_shape_errors_match_jax():
    for n, kw in ((8, dict(tp=3)), (6, dict(tp=4)), (8, dict(sp=0))):
        with pytest.raises(JaxMXNetError) as jerr:
            jpar.default_mesh_shape(n, **kw)
        with pytest.raises(MXNetError) as terr:
            tmesh.default_mesh_shape(n, **kw)
        assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("axes", [dict(dp=8), dict(dp=2, tp=2, sp=2),
                                  dict(dp=2, pp=2, tp=2), dict(sp=4),
                                  dict(dp=2, tp=2, ep=2)])
def test_create_mesh_factors_like_jax(axes):
    jm, tm = _meshes(**axes)
    assert tm.axis_names == tuple(jm.axis_names)
    assert tm.devices.shape == jm.devices.shape
    assert tm.shape == dict(jm.shape)
    # JAX enumerates its devices row-major over the mesh; the port's
    # coordinates run in the same order
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    assert tm.coords == [tuple(int(i) for i in np.argwhere(ids == k)[0])
                         for k in range(tm.size)]
    assert all(d == CPU for d in tm.devices.flat)


def test_create_mesh_axis_order_and_absent_axes():
    jm = jpar.create_mesh({"tp": 2, "dp": 4}, devices=jax.devices()[:8],
                          axis_order=("tp", "dp"))
    tm = tmesh.create_mesh({"tp": 2, "dp": 4}, devices=[CPU] * 8,
                           axis_order=("tp", "dp"))
    assert tm.axis_names[:2] == tuple(jm.axis_names)
    # the canonical axes the shape leaves out are there at size 1
    assert tm.shape == {"tp": 2, "dp": 4, "pp": 1, "sp": 1, "ep": 1}
    assert tmesh.create_mesh(devices=[CPU] * 4).shape["dp"] == 4


def test_create_mesh_errors_match_jax():
    shape = _full(dp=2, tp=2)
    with pytest.raises(JaxMXNetError) as jerr:
        jpar.create_mesh(shape, devices=jax.devices()[:3])
    with pytest.raises(MXNetError) as terr:
        tmesh.create_mesh(shape, devices=[CPU] * 3)
    assert str(terr.value) == str(jerr.value)


def test_a_mesh_without_a_card_raises(monkeypatch):
    """The default device list is every visible card; with none the mesh
    raises instead of falling back to the CPU, even when the default
    context is the CPU."""
    from mxtpu_torch import context

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(context, "default_ctx", lambda: CPU)
    for call in (lambda: tmesh.create_mesh(),
                 lambda: tmesh.create_mesh({"dp": 2}),
                 lambda: tmesh.create_mesh(devices=["cuda:0"] * 2)):
        with pytest.raises(MXNetError, match="no CUDA device"):
            call()


def test_a_one_device_mesh_is_the_one_device_mesh():
    a = tmesh.create_mesh(devices=[CPU])
    b = tmesh.create_mesh({"dp": 1, "tp": 1}, devices=["cpu"])
    assert a == b and hash(a) == hash(b) and a.size == 1
    assert a.device == CPU and a.shape == _full()
    assert tmesh.create_mesh(devices=[CPU] * 2) != a


def test_mesh_context_nests_like_jax():
    jm, tm = _meshes(dp=8)
    _, tm2 = _meshes(dp=2, tp=2)
    assert tmesh.current_mesh() is None and jpar.current_mesh() is None
    with tmesh.MeshContext(tm) as got, jpar.MeshContext(jm):
        assert got is tm and tmesh.current_mesh() is tm
        assert tmesh.axis_size("dp") == jpar.current_mesh().shape["dp"]
        with tmesh.MeshContext(tm2):
            assert tmesh.current_mesh() is tm2
            assert tmesh.axis_size("tp") == 2
        assert tmesh.current_mesh() is tm
    assert tmesh.current_mesh() is None
    assert tmesh.axis_size("tp", tm2) == 2
    with pytest.raises(MXNetError, match="no mesh"):
        tmesh.axis_size("dp")


# -- shards -------------------------------------------------------------------

@pytest.mark.parametrize("spec", [P(), P("dp"), P(None, "tp"),
                                  P("tp", "sp"), P(("dp", "tp"), None),
                                  P(("tp", "dp"), "sp")])
def test_shard_gather_round_trip_matches_jax_layout(spec):
    """Each coordinate's block is the one JAX's NamedSharding puts on
    that coordinate's device; gather puts them back together."""
    from jax.sharding import NamedSharding, PartitionSpec

    jm, tm = _meshes(dp=2, tp=2, sp=2)
    x = np.arange(8 * 12, dtype=np.float32).reshape(8, 12)
    ja = jax.device_put(x, NamedSharding(jm, PartitionSpec(*spec)))
    s = spmd.shard(x, tm, spec)
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    by_dev = {sh.device.id: np.asarray(sh.data)
              for sh in ja.addressable_shards}
    for coord, t in zip(tm.coords, s.shards):
        np.testing.assert_array_equal(t.numpy(), by_dev[ids[coord]])
    np.testing.assert_array_equal(s.gather().numpy(), x)
    assert s.shape == (8, 12) and s.nbytes == x.nbytes
    assert sum(s.device_nbytes()) == sum(
        sh.data.nbytes for sh in ja.addressable_shards)
    # every shard is a copy of its own
    ptrs = {t.data_ptr() for t in s.shards}
    assert len(ptrs) == tm.size


def test_shard_rejects_an_indivisible_dimension():
    _, tm = _meshes(dp=2, tp=2, sp=2)
    with pytest.raises(MXNetError, match="does not divide"):
        spmd.shard(np.zeros((3, 4), np.float32), tm, P("dp"))


def test_psum_gradient_is_the_psum_of_the_cotangents():
    _, tm = _meshes(dp=2, tp=2)
    xs = [torch.full((3,), float(i + 1), requires_grad=True)
          for i in range(tm.size)]
    out = spmd.psum(tm, xs, "tp")
    weights = [float(10 ** i) for i in range(tm.size)]
    loss = sum(w * o.sum() for w, o in zip(weights, out))
    grads = torch.autograd.grad(loss, xs)
    for members in spmd.groups(tm, "tp"):
        want = sum(weights[j] for j in members)
        for i in members:
            assert torch.all(grads[i] == want)
        assert all(out[i].tolist() == [float(sum(j + 1 for j in members))] * 3
                   for i in members)


# -- the eager collectives ------------------------------------------------------

def _cases(n):
    k = 2 * n
    return {
        "all_reduce": (np.arange(n * 3, dtype=np.float32).reshape(n, 3), {}),
        "all_gather": (np.arange(n * 2, dtype=np.float32), {}),
        "reduce_scatter": (np.arange(n * k, dtype=np.float32), {}),
        "all_to_all": (np.arange(n * n * 2,
                                 dtype=np.float32).reshape(n, n, 2), {}),
        "collective_permute": (np.arange(n * 2, dtype=np.float32),
                               {"perm": [(i, (i + 1) % n) for i in range(n)]}),
    }


@pytest.mark.parametrize("axes,axis", [(dict(dp=8), "dp"),
                                       (dict(dp=2, tp=4), "tp"),
                                       (dict(dp=4, ep=2), "ep")])
def test_collectives_match_jax(axes, axis):
    jm, tm = _meshes(**axes)
    n = tm.shape[axis]
    for name, (x, kw) in _cases(n).items():
        want = np.asarray(getattr(jpar, name)(x, axis=axis, mesh=jm, **kw))
        got = getattr(tcol, name)(x, axis=axis, mesh=tm, **kw)
        assert isinstance(got, torch.Tensor) and got.device == CPU
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    assert tcol.psum_scalar(2.5, axis=axis, mesh=tm) == \
        jpar.psum_scalar(2.5, axis=axis, mesh=jm) == 2.5 * n


def test_collective_permute_leaves_non_destinations_zero_like_jax():
    jm, tm = _meshes(dp=8)
    x = np.arange(16, dtype=np.float32) + 1
    perm = [(0, 3), (5, 1)]
    np.testing.assert_array_equal(
        tcol.collective_permute(x, perm, mesh=tm).numpy(),
        np.asarray(jpar.collective_permute(x, perm, mesh=jm)))


def test_collectives_resolve_the_mesh_and_axis_like_jax():
    from mxtpu.sharding import ShardingPlan as JPlan
    from mxtpu.sharding import plan_scope as jplan_scope

    jm, tm = _meshes(dp=4, tp=2)
    x = np.arange(8, dtype=np.float32).reshape(4, 2)
    with pytest.raises(MXNetError, match="no mesh"):
        tcol.all_reduce(x)
    with tmesh.MeshContext(tm), jpar.MeshContext(jm):
        np.testing.assert_array_equal(tcol.all_reduce(x).numpy(),
                                      np.asarray(jpar.all_reduce(x)))
    # the active plan gives the mesh, and axis=None its data axis
    with plan_scope(ShardingPlan(mesh=tm, data_axis="tp")), \
            jplan_scope(JPlan(mesh=jm, data_axis="tp")):
        y = np.arange(4, dtype=np.float32).reshape(2, 2)
        np.testing.assert_array_equal(
            tcol.all_reduce(y, axis=None).numpy(),
            np.asarray(jpar.all_reduce(y, axis=None)))
    # an explicit mesh wins over the context's
    _, other = _meshes(dp=8)
    with tmesh.MeshContext(other):
        assert tcol.all_reduce(x, mesh=tm).shape == (1, 2)


def test_collectives_take_and_give_ndarrays():
    from mxtpu_torch.ndarray import NDArray

    _, tm = _meshes(dp=4)
    x = NDArray(torch.arange(8, dtype=torch.float32).reshape(4, 2))
    out = tcol.all_reduce(x, mesh=tm)
    assert isinstance(out, NDArray)
    assert out.asnumpy().tolist() == [[12.0, 16.0]]


def test_microbench_checks_each_collective(capsys):
    _, tm = _meshes(dp=2, tp=4)
    res = tcol.microbench(tm, n_bytes=1 << 12, reps=1)
    assert set(res) == {"dp", "tp"}
    for axis_res in res.values():
        assert set(axis_res) == {"all_reduce", "all_gather",
                                 "reduce_scatter", "all_to_all", "ppermute"}
        assert all(r["ok"] and r["ms"] > 0 for r in axis_res.values())
    assert "same-device copies" in capsys.readouterr().out
