"""The PyTorch port's gluon Parameter, ParameterDict and Block
(`mxtpu_torch/gluon/parameter.py`, `block.py`) against the JAX
package's: deferred initialisation, `grad_req`, `set_data`, `var()`,
the names of a model's Parameters and blocks, `save_parameters`/
`load_parameters` both ways between the packages, `load_numpy`, `cast`,
and the entry points' device.
"""
import json

import numpy as np
import pytest

import mxtpu as jmx
import mxtpu_torch as tmx
from mxtpu_torch.base import MXNetError
from mxtpu_torch.gluon.parameter import load_numpy
from test_torch_gluon import _build, _seq, _x


def test_deferred_initialisation_waits_for_the_first_forward():
    net = tmx.gluon.nn.Dense(3)
    net.initialize(ctx=tmx.cpu())
    assert net.weight.shape == (3, 0)
    with pytest.raises(tmx.gluon.DeferredInitializationError):
        net.weight.data()
    net(tmx.nd.ones((2, 5), ctx=tmx.cpu()))
    assert net.weight.data().shape == (3, 5)
    assert net.weight.list_ctx() == [tmx.cpu()]
    with pytest.raises(MXNetError, match="invalid shape"):
        tmx.gluon.Parameter("w", shape=(0, 2)).initialize(ctx=tmx.cpu())
    with pytest.raises(MXNetError, match="not been initialized"):
        tmx.gluon.Parameter("w", shape=(2,)).data()


def test_grad_req_null_write_and_add_match_the_reference():
    x = _x(2, 4)
    res = []
    for mx in (jmx, tmx):
        net = _build(mx, lambda m: m.gluon.nn.Dense(3, in_units=4))
        net.initialize(mx.init.One(), ctx=mx.cpu())
        net.weight.grad_req = "add"
        net.weight._init_grad()
        net.bias.grad_req = "null"
        net.bias._init_grad()
        for _ in range(2):
            with mx.autograd.record():
                out = net(mx.nd.array(x, ctx=mx.cpu()))
            out.backward()
        with pytest.raises((MXNetError, jmx.base.MXNetError)):
            net.bias.grad()
        res.append(net.weight.grad().asnumpy())
        net.weight.zero_grad()
        assert not net.weight.grad().asnumpy().any()
    np.testing.assert_allclose(res[1], res[0], rtol=1e-6)
    np.testing.assert_allclose(res[1], 2 * x.sum(0)[None].repeat(3, 0),
                               rtol=1e-6)


def test_set_data_writes_in_place_and_keeps_the_leaf():
    p = tmx.gluon.Parameter("fc_weight", shape=(2, 3))
    p.initialize(ctx=tmx.cpu())
    arr = p.data()
    leaf = arr._data
    p.set_data(np.arange(6, dtype=np.float64).reshape(2, 3))
    assert p.data() is arr and arr._data is leaf and leaf.requires_grad
    np.testing.assert_array_equal(arr.asnumpy(), np.arange(6).reshape(2, 3))
    with pytest.raises(MXNetError, match="cannot update shape"):
        p.set_data(np.zeros((3, 2)))


def test_var_matches_the_reference():
    for name, kw in (("w", dict(shape=(2, 3))), ("d", dict(shape=(0, 3))),
                     ("bn_running_mean", dict(shape=(4,), grad_req="null")),
                     ("bn_gamma", dict(shape=(4,), grad_req="null"))):
        syms = [mx.gluon.Parameter(name, **kw).var() for mx in (jmx, tmx)]
        assert json.loads(syms[1].tojson()) == json.loads(syms[0].tojson())


def test_parameter_dict_and_constant():
    d = tmx.gluon.ParameterDict("net_")
    w = d.get("weight", shape=(0, 3))
    assert d.get("weight", shape=(4, 0)) is w and w.shape == (4, 3)
    with pytest.raises(MXNetError, match="inconsistent"):
        d.get("weight", shape=(5, 3))
    with pytest.raises(MXNetError, match="inconsistent"):
        d.get("weight", dtype="float16")
    c = d.get_constant("c", [[1.0, 2.0]])
    assert d.get_constant("c") is c and c.grad_req == "null"
    d.initialize(ctx=tmx.cpu())
    np.testing.assert_array_equal(c.data().asnumpy(), [[1.0, 2.0]])
    assert list(d.keys()) == ["net_weight", "net_c"]
    shared = tmx.gluon.ParameterDict("net_", shared=d)
    assert shared.get("weight") is w


def test_names_and_collect_params_match_the_reference():
    nets = [_build(mx, lambda m: m.gluon.model_zoo.vision.resnet18_v1(
        classes=10)) for mx in (jmx, tmx)]
    for sel in (None, ".*running.*", ".*stage2.*weight"):
        assert list(nets[1].collect_params(sel).keys()) == \
            list(nets[0].collect_params(sel).keys())
    assert list(nets[1]._collect_params_with_prefix()) == \
        list(nets[0]._collect_params_with_prefix())
    assert nets[1].name == nets[0].name == "resnetv10"
    assert repr(nets[1]).splitlines()[:4] == repr(nets[0]).splitlines()[:4]
    assert [type(c).__name__ for c in nets[1].features] == \
        [type(c).__name__ for c in nets[0].features]


def test_save_and_load_parameters_round_trip_both_ways(tmp_path):
    x = _x(2, 3, 8, 8)

    def net(mx):
        return _build(mx, _seq)

    def forward(blk, mx):
        with mx.autograd.predict_mode():
            return blk(mx.nd.array(x, ctx=mx.cpu())).asnumpy()

    j = net(jmx)
    j.initialize(jmx.init.Xavier(), ctx=jmx.cpu())
    want = forward(j, jmx)
    j.save_parameters(str(tmp_path / "ref.params"))
    t = net(tmx)
    t.load_parameters(str(tmp_path / "ref.params"), ctx=tmx.cpu())
    np.testing.assert_allclose(forward(t, tmx), want, rtol=1e-5, atol=1e-6)
    t.save_parameters(str(tmp_path / "port.params"))
    t2 = net(tmx)
    t2.initialize(ctx=tmx.cpu())
    t2.load_parameters(str(tmp_path / "port.params"))
    np.testing.assert_array_equal(forward(t2, tmx), forward(t, tmx))
    j2 = net(jmx)
    j2.load_parameters(str(tmp_path / "port.params"), ctx=jmx.cpu())
    np.testing.assert_allclose(forward(j2, jmx), want, rtol=1e-6)
    t3 = _build(tmx, lambda m: m.gluon.nn.Dense(2, in_units=3))
    with pytest.raises(MXNetError, match="missing in file"):
        t3.load_parameters(str(tmp_path / "port.params"), ctx=tmx.cpu())
    with pytest.raises(MXNetError, match="not in this Block"):
        t3.load_parameters(str(tmp_path / "port.params"), ctx=tmx.cpu(),
                           allow_missing=True)


def test_load_numpy_needs_every_name():
    net = _build(tmx, lambda m: m.gluon.nn.Dense(2, in_units=3))
    net.initialize(ctx=tmx.cpu())
    with pytest.raises(MXNetError, match="no array for"):
        load_numpy(net.collect_params(), {"dense0_weight": np.zeros((2, 3))})
    with pytest.raises(MXNetError, match="no parameter for"):
        load_numpy(net.collect_params(), {
            "dense0_weight": np.zeros((2, 3)), "dense0_bias": np.zeros(2),
            "extra": np.zeros(1)})


def test_cast_and_hybrid_children():
    net = _build(tmx, _seq)
    net.initialize(ctx=tmx.cpu())
    net(tmx.nd.array(_x(2, 3, 8, 8), ctx=tmx.cpu()))
    net.cast("float64")
    assert all(p.data().dtype == np.float64
               for p in net.collect_params().values())
    out = net(tmx.nd.array(_x(2, 3, 8, 8), ctx=tmx.cpu(), dtype="float64"))
    assert out.dtype == np.float64
    with pytest.raises(MXNetError, match="HybridBlocks"):
        net.register_child(tmx.gluon.nn.Lambda("relu"))


def test_entry_points_default_to_the_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    net = tmx.gluon.nn.Dense(2, in_units=3)
    with pytest.raises(MXNetError, match="no CUDA device"):
        net.initialize()
    with pytest.raises(MXNetError, match="no CUDA device"):
        tmx.gluon.utils.split_and_load(np.zeros((2, 3)), [tmx.gpu(0)])


def test_hybridize_flags_without_an_analog_are_accepted():
    net = tmx.gluon.nn.Dense(2, in_units=3)
    net.initialize(ctx=tmx.cpu())
    net.hybridize(static_alloc=True, static_shape=True)
    assert net(tmx.nd.ones((1, 3), ctx=tmx.cpu())).shape == (1, 2)
    net.hybridize(shape_buckets="pow2")
    with pytest.raises(MXNetError, match="not ported"):
        net(tmx.nd.ones((1, 3), ctx=tmx.cpu()))

