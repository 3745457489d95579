"""The PyTorch port's INT8 workflow (`mxtpu_torch/contrib/quantization.py`)
against the JAX package's (`mxtpu/contrib/quantization.py`) on the CPU,
from the same numpy weights and calibration batches.

* `_optimal_threshold` (the port's own copy of the numpy code) returns
  the same threshold on the same histograms.
* Calibration, in `naive` and `entropy` modes, gives each tensor the
  same range: within `RANGE_TOL` relative (the fp32 activations are
  each package's own float32 convolutions, so a value may differ in its
  last bits; the entropy threshold is a bin edge, and it is the same
  edge).
* `quantize_model` rewrites the graph to the same nodes (op and name,
  in order) with the same arguments, and quantizes the same parameters
  to the same int8 arrays with the same (1,) ranges; a no-bias slot gets
  the zero int8 stand-in.
* The quantized graph's softmax agrees with `mxtpu`'s within `OUT_TOL`
  (an activation on a rounding boundary may quantize one step apart),
  and both track the fp32 graph as `tests/test_contrib.py` asks, on the
  small convnet and on `resnet18_v1` at 32x32 as `tests/test_contrib.py`
  quantizes it.
"""
import numpy as np
import pytest
import torch

import mxtpu as jmx
import mxtpu_torch as tmx
from mxtpu.contrib import quantization as jq
from mxtpu_torch.contrib import quantization as tq

torch.set_num_threads(1)

RANGE_TOL = 1e-5
OUT_TOL = 2e-3


def small_convnet(mx):
    s = mx.sym
    x = s.Convolution(data=s.Variable("data"), kernel=(3, 3), num_filter=8,
                      pad=(1, 1), name="conv0")
    x = s.Activation(data=x, act_type="relu", name="relu0")
    x = s.Pooling(data=x, kernel=(2, 2), stride=(2, 2), pool_type="max",
                  name="pool0")
    x = s.Convolution(data=x, kernel=(1, 1), num_filter=6, no_bias=True,
                      name="conv1")
    x = s.FullyConnected(data=s.Flatten(data=x, name="flat0"),
                         num_hidden=10, name="fc0")
    return s.softmax(data=x, name="out")


def convnet_params(seed=0):
    rng = np.random.RandomState(seed)
    return {"conv0_weight": rng.randn(8, 3, 3, 3).astype(np.float32) * 0.3,
            "conv0_bias": rng.randn(8).astype(np.float32) * 0.1,
            "conv1_weight": rng.randn(6, 8, 1, 1).astype(np.float32) * 0.3,
            "fc0_weight": rng.randn(10, 6 * 4 * 4).astype(np.float32) * 0.3,
            "fc0_bias": rng.randn(10).astype(np.float32) * 0.1}


def nd_dict(mx, arrays):
    return {k: mx.nd.array(v, ctx=mx.cpu(), dtype=v.dtype)
            for k, v in arrays.items()}


def calib_iter(mx, x, name="data", batch=8):
    kw = {"ctx": mx.cpu()} if mx is tmx else {}
    return mx.io.NDArrayIter({name: x}, batch_size=batch, **kw)


def forward(mx, symbol, args, aux, x, name="data"):
    names = set(symbol.list_arguments())
    shapes = {name: x.shape}
    shapes.update({k: tuple(v.shape) for k, v in args.items()
                   if k in names})
    exe = symbol.simple_bind(ctx=mx.cpu(), grad_req="null",
                             type_dict={k: v.dtype for k, v in args.items()
                                        if k in names}, **shapes)
    exe.copy_params_from(args, aux, allow_extra_params=True)
    return exe.forward(is_train=False,
                       **{name: mx.nd.array(x, ctx=mx.cpu())})[0].asnumpy()


def quantize_both(make, args, aux, calib, mode, name="data", **kw):
    """quantize_model in each package: [(qsym, {qarg: numpy},
    {qaux: numpy})] for mxtpu, then the port."""
    out = []
    for mx, q in ((jmx, jq), (tmx, tq)):
        qsym, qargs, qaux = q.quantize_model(
            make(mx), nd_dict(mx, args), nd_dict(mx, aux),
            data_names=(name,), calib_mode=mode,
            calib_data=calib_iter(mx, calib, name) if mode != "none"
            else None, **kw)
        out.append((qsym, {k: v.asnumpy() for k, v in qargs.items()},
                    {k: v.asnumpy() for k, v in qaux.items()}))
    return out


def graph_of(symbol):
    return [(n.name, None if n.is_variable else n.op.name)
            for n in symbol._topo()]


def test_optimal_threshold_is_the_same_code():
    rng = np.random.RandomState(0)
    for data in (rng.randn(20000), np.maximum(rng.randn(20000), 0) ** 2,
                 rng.standard_t(3, 20000)):
        t = float(np.abs(data).max())
        hist, edges = np.histogram(data, bins=np.linspace(-t, t, 8002))
        assert tq._optimal_threshold(hist, edges) == \
            jq._optimal_threshold(hist, edges)


@pytest.mark.parametrize("mode", ["naive", "entropy"])
def test_calibrated_ranges_match(mode):
    args = convnet_params()
    x = np.random.RandomState(1).rand(32, 3, 8, 8).astype(np.float32)
    ranges = []
    for mx, q in ((jmx, jq), (tmx, tq)):
        kw = {} if mx is jmx else {"ctx": tmx.cpu()}
        ranges.append(q.calibrate_ranges(
            small_convnet(mx), nd_dict(mx, args), {}, calib_iter(mx, x),
            calib_mode=mode, **kw))
    want, got = ranges
    assert sorted(got) == sorted(want) == ["data", "flat0_output",
                                           "pool0_output"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RANGE_TOL, err_msg=k)


@pytest.mark.parametrize("mode", ["naive", "entropy", "none"])
def test_quantize_model_matches_on_a_convnet(mode):
    args = convnet_params()
    rng = np.random.RandomState(2)
    calib = rng.rand(32, 3, 8, 8).astype(np.float32)
    (jsym, jargs, _), (tsym, targs, taux) = quantize_both(
        small_convnet, args, {}, calib, mode, ctx=tmx.cpu())
    assert graph_of(tsym) == graph_of(jsym)
    assert tsym.list_arguments() == jsym.list_arguments()
    ops = {op for _, op in graph_of(tsym)}
    assert {"_contrib_quantized_conv", "_contrib_quantized_fully_connected",
            "_contrib_quantize_v2", "_contrib_dequantize"} <= ops
    assert sorted(targs) == sorted(jargs) and not taux
    for k in jargs:
        assert targs[k].dtype == jargs[k].dtype, k
        assert targs[k].shape == jargs[k].shape, k
        np.testing.assert_array_equal(targs[k], jargs[k], err_msg=k)
    assert targs["conv0_weight_quantize"].dtype == np.int8
    assert targs["conv0_weight_min"].shape == (1,)
    np.testing.assert_array_equal(targs["conv1_no_bias"],
                                  np.zeros(1, np.int8))
    x = rng.rand(4, 3, 8, 8).astype(np.float32)
    want = forward(jmx, jsym, nd_dict(jmx, jargs), {}, x)
    got = forward(tmx, tsym, nd_dict(tmx, targs), {}, x)
    np.testing.assert_allclose(got, want, rtol=0, atol=OUT_TOL)
    full = forward(tmx, small_convnet(tmx), nd_dict(tmx, args), {}, x)
    assert np.abs(got - full).max() < (0.05 if mode != "entropy" else 0.15)


def test_excluded_ops_stay_float():
    args = convnet_params()
    for mx, q in ((jmx, jq), (tmx, tq)):
        qsym, _, _ = q.quantize_model(
            small_convnet(mx), nd_dict(mx, args), {}, calib_mode="none",
            excluded_sym_names=("conv0", "fc0"))
        ops = [op for _, op in graph_of(qsym)]
        assert ops.count("_contrib_quantized_conv") == 1
        assert "_contrib_quantized_fully_connected" not in ops


def resnet18(mx):
    from importlib import import_module

    vision = import_module(mx.__name__ + ".gluon.model_zoo.vision")
    with mx.sym.NameManager():
        out, _, _ = vision.resnet18_v1(classes=10)._trace_symbol(
            mx.sym.var("data0"))
        return mx.sym.softmax(data=out, name="prob")


def test_quantize_resnet18_matches():
    net = resnet18(tmx)
    arg_shapes, _, aux_shapes = net.infer_shape(data0=(2, 3, 32, 32))
    rng = np.random.RandomState(0)
    args = {n: (rng.randn(*s) * (0.1 if n.endswith("weight") else 0.02))
            .astype(np.float32)
            for n, s in zip(net.list_arguments(), arg_shapes)
            if n != "data0"}
    for n in args:
        if n.endswith("gamma"):
            args[n] = 1.0 + args[n]
    aux = {n: (rng.uniform(0.5, 1.5, s) if n.endswith("var")
               else rng.randn(*s) * 0.1).astype(np.float32)
           for n, s in zip(net.list_auxiliary_states(), aux_shapes)}
    calib = rng.rand(8, 3, 32, 32).astype(np.float32)
    (jsym, jargs, jaux), (tsym, targs, taux) = quantize_both(
        resnet18, args, aux, calib, "naive", name="data0", ctx=tmx.cpu())
    assert graph_of(tsym) == graph_of(jsym)
    ops = [op for _, op in graph_of(tsym)]
    assert ops.count("_contrib_quantized_conv") == 20
    assert ops.count("_contrib_quantized_fully_connected") == 1
    for k in jargs:
        np.testing.assert_array_equal(targs[k], jargs[k], err_msg=k)
    x = rng.rand(2, 3, 32, 32).astype(np.float32)
    want = forward(jmx, jsym, nd_dict(jmx, jargs), nd_dict(jmx, jaux), x,
                   "data0")
    got = forward(tmx, tsym, nd_dict(tmx, targs), nd_dict(tmx, taux), x,
                  "data0")
    assert got.shape == (2, 10) and np.isfinite(got).all()
    np.testing.assert_allclose(got.sum(1), 1.0, rtol=1e-4)
    np.testing.assert_allclose(got, want, rtol=0, atol=OUT_TOL)


def test_the_contrib_modules_not_ported_raise_naming_a19():
    for name in ("onnx", "text", "svrg_optimization", "tensorboard"):
        with pytest.raises(tmx.MXNetError, match="A19"):
            getattr(tmx.contrib, name)
    with pytest.raises(AttributeError):
        tmx.contrib.no_such_module
