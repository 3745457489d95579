"""Channels-last Convolution and Pooling of the PyTorch port
(`mxtpu_torch/ops/nn.py`) against the JAX package's
(`mxtpu/ops/nn.py:102-141`, `:206-248`): NWC, NHWC and NDHWC
convolutions (groups, dilation, stride, padding, bias) and poolings
(max, avg, sum, lp; global; the valid and full conventions), forward and
gradients through `autograd`; `MXTPU_CONV_LAYOUT=NHWC` leaving an NCHW
convolution's values as they were; and the symbolic side: parity with
the JAX package where its shape inference works (H == C), and the
port's corrected inference of the weight (the input channels read from
the layout's C axis) at H != C, where the JAX package fails, held to the
NCHW graph on the same weights.

Tolerance: float32's (rtol 1e-4, atol 1e-5 times the largest magnitude
of the reference value).
"""
import numpy as np
import pytest
import torch

import mxtpu as jmx
import mxtpu_torch as tmx

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5


def _close(got, want, what=""):
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=RTOL,
                               atol=ATOL * scale, err_msg=what)


def _run(mx, op, inputs, head, **attrs):
    """op's output and the gradients of sum(output * head) with respect
    to every input, in package ``mx`` on the CPU."""
    kw = dict(ctx=mx.cpu())
    arrs = [mx.nd.array(a, **kw) for a in inputs]
    for a in arrs:
        a.attach_grad()
    with mx.autograd.record():
        out = getattr(mx.nd, op)(*arrs, **attrs)
        loss = (out * mx.nd.array(head, **kw)).sum()
    loss.backward()
    return out.asnumpy(), [a.grad.asnumpy() for a in arrs]


def _conv_case(ns, groups, dilate, stride, pad, bias, seed=0):
    rng = np.random.RandomState(seed)
    spatial = (7, 6, 5)[:ns]
    cin, nf, k = 4, 8, (3, 2, 3)[:ns]
    x = rng.randn(2, *spatial, cin).astype(np.float32)
    w = rng.randn(nf, cin // groups, *k).astype(np.float32)
    attrs = dict(kernel=k, num_filter=nf, num_group=groups,
                 dilate=(dilate,) * ns, stride=(stride,) * ns,
                 pad=(pad,) * ns, no_bias=not bias,
                 layout="N" + "DHW"[3 - ns:] + "C")
    inputs = [x, w] + ([rng.randn(nf).astype(np.float32)] if bias else [])
    return inputs, attrs


CONV_CASES = [
    (1, 1, 1, 1, 0, True), (1, 2, 2, 1, 1, False),
    (2, 1, 1, 1, 1, True), (2, 2, 1, 2, 0, False), (2, 4, 2, 1, 2, True),
    (3, 1, 1, 1, 1, True), (3, 2, 1, 2, 1, False),
]


@pytest.mark.parametrize("ns,groups,dilate,stride,pad,bias", CONV_CASES)
def test_channels_last_convolution_matches_the_reference(ns, groups, dilate,
                                                         stride, pad, bias):
    inputs, attrs = _conv_case(ns, groups, dilate, stride, pad, bias)
    probe = jmx.nd.Convolution(*[jmx.nd.array(a) for a in inputs], **attrs)
    head = np.random.RandomState(9).randn(*probe.shape).astype(np.float32)
    t_out, t_grads = _run(tmx, "Convolution", inputs, head, **attrs)
    j_out, j_grads = _run(jmx, "Convolution", inputs, head, **attrs)
    assert t_out.shape == j_out.shape
    assert t_out.shape[-1] == attrs["num_filter"]
    _close(t_out, j_out, "output")
    for name, t, j in zip(("data", "weight", "bias"), t_grads, j_grads):
        _close(t, j, name)


@pytest.mark.parametrize("ns", [2, 3])
def test_channels_last_output_is_contiguous_with_no_copy_back(ns):
    inputs, attrs = _conv_case(ns, 1, 1, 1, 1, True)
    with tmx.cpu():
        out = tmx.nd.Convolution(*[tmx.nd.array(a) for a in inputs], **attrs)
    assert out._data.is_contiguous()
    ref = tmx.nd.Convolution(
        *[tmx.nd.array(np.moveaxis(inputs[0], -1, 1), ctx=tmx.cpu())]
        + [tmx.nd.array(a, ctx=tmx.cpu()) for a in inputs[1:]],
        **dict(attrs, layout=None))
    _close(out.asnumpy(), np.moveaxis(ref.asnumpy(), 1, -1))


POOL_CASES = [
    (2, "max", "valid", False), (2, "avg", "valid", True),
    (2, "avg", "full", False), (2, "sum", "valid", False),
    (2, "lp", "valid", False), (2, "max", "full", False),
    (1, "max", "valid", False), (1, "avg", "full", True),
    (3, "max", "valid", False), (3, "avg", "valid", True),
]


@pytest.mark.parametrize("ns,pool_type,convention,count_pad", POOL_CASES)
def test_channels_last_pooling_matches_the_reference(ns, pool_type,
                                                     convention, count_pad):
    rng = np.random.RandomState(1)
    x = rng.randn(2, *((7, 6, 5)[:ns]), 3).astype(np.float32)
    attrs = dict(kernel=(3, 2, 2)[:ns], stride=(2,) * ns, pad=(1,) * ns,
                 pool_type=pool_type, pooling_convention=convention,
                 count_include_pad=count_pad,
                 layout="N" + "DHW"[3 - ns:] + "C")
    if pool_type == "lp":
        attrs["p_value"] = 2
    probe = jmx.nd.Pooling(jmx.nd.array(x), **attrs)
    head = rng.randn(*probe.shape).astype(np.float32)
    t_out, (t_g,) = _run(tmx, "Pooling", [x], head, **attrs)
    j_out, (j_g,) = _run(jmx, "Pooling", [x], head, **attrs)
    assert t_out.shape == j_out.shape
    _close(t_out, j_out, "output")
    _close(t_g, j_g, "gradient")


@pytest.mark.parametrize("pool_type", ["max", "avg", "sum", "lp"])
def test_channels_last_global_pooling_matches_the_reference(pool_type):
    x = np.random.RandomState(2).randn(2, 5, 4, 3).astype(np.float32)
    attrs = dict(kernel=(1, 1), global_pool=True, pool_type=pool_type,
                 layout="NHWC")
    head = np.random.RandomState(3).randn(2, 1, 1, 3).astype(np.float32)
    t_out, (t_g,) = _run(tmx, "Pooling", [x], head, **attrs)
    j_out, (j_g,) = _run(jmx, "Pooling", [x], head, **attrs)
    assert t_out.shape == j_out.shape == (2, 1, 1, 3)
    _close(t_out, j_out)
    _close(t_g, j_g)


@pytest.mark.parametrize("ns", [1, 2, 3])
def test_conv_layout_env_leaves_nchw_results_equal(monkeypatch, ns):
    inputs, attrs = _conv_case(ns, 2, 1, 1, 1, True, seed=4)
    inputs[0] = np.ascontiguousarray(np.moveaxis(inputs[0], -1, 1))
    attrs = dict(attrs, layout=None)
    probe = jmx.nd.Convolution(*[jmx.nd.array(a) for a in inputs], **attrs)
    head = np.random.RandomState(5).randn(*probe.shape).astype(np.float32)
    plain = _run(tmx, "Convolution", inputs, head, **attrs)
    monkeypatch.setenv("MXTPU_CONV_LAYOUT", "NHWC")
    env = _run(tmx, "Convolution", inputs, head, **attrs)
    ref = _run(jmx, "Convolution", inputs, head, **attrs)
    for got, want in ((env[0], plain[0]), (env[0], ref[0])):
        _close(got, want)
    for g_env, g_plain, g_ref in zip(env[1], plain[1], ref[1]):
        _close(g_env, g_plain)
        _close(g_env, g_ref)
    if ns == 2:
        with tmx.cpu():
            out = tmx.nd.Convolution(*[tmx.nd.array(a) for a in inputs],
                                     **attrs)
        assert out._data.is_contiguous(memory_format=torch.channels_last)


def _nhwc_graph(mx, layout):
    """conv -> BN -> relu -> max pool -> conv -> global avg pool -> FC,
    channels-last when ``layout`` is NHWC; every convolution keeps the
    spatial size, so that with H == C every one of them has H == C."""
    cl = layout == "NHWC"
    lay = dict(layout=layout) if cl else {}
    sym = mx.sym
    data = sym.Variable("data")
    c1 = sym.Convolution(data, kernel=(3, 3), pad=(1, 1), num_filter=4,
                         no_bias=True, name="c1", **lay)
    b1 = sym.BatchNorm(c1, fix_gamma=False, axis=3 if cl else 1, name="b1")
    r1 = sym.Activation(b1, act_type="relu", name="r1")
    p1 = sym.Pooling(r1, kernel=(3, 3), pad=(1, 1), pool_type="max",
                     name="p1", **lay)
    c2 = sym.Convolution(p1, kernel=(3, 3), pad=(1, 1), num_filter=5,
                         name="c2", **lay)
    g = sym.Pooling(c2, kernel=(1, 1), global_pool=True, pool_type="avg",
                    name="gp", **lay)
    return sym.FullyConnected(sym.Flatten(g), num_hidden=3, name="fc")


def _bind_run(mx, symbol, data, params, is_train):
    ex = symbol.simple_bind(ctx=mx.cpu(), grad_req="write",
                            data=data.shape)
    for name, arr in ex.arg_dict.items():
        arr[:] = data if name == "data" else params[name]
    outs = ex.forward(is_train=is_train)
    grads = {}
    if is_train:
        ex.backward([mx.nd.ones(outs[0].shape, ctx=mx.cpu())])
        grads = {n: g.asnumpy() for n, g in ex.grad_dict.items()
                 if g is not None}
    return outs[0].asnumpy(), grads, ex


def _params(symbol, data_shape, seed):
    arg_shapes, _, _ = symbol.infer_shape(data=data_shape)
    rng = np.random.RandomState(seed)
    return {n: rng.randn(*s).astype(np.float32) * 0.3
            for n, s in zip(symbol.list_arguments(), arg_shapes)
            if n != "data"}


@pytest.mark.parametrize("is_train", [False, True])
def test_symbolic_nhwc_matches_the_reference_where_its_inference_works(
        is_train):
    # H == C == 4: the JAX package's weight inference reads data[1] (H)
    data = np.random.RandomState(6).randn(2, 4, 4, 4).astype(np.float32)
    tsym, jsym = _nhwc_graph(tmx, "NHWC"), _nhwc_graph(jmx, "NHWC")
    t_shapes = tsym.infer_shape(data=data.shape)
    assert t_shapes == tuple(jsym.infer_shape(data=data.shape))
    params = _params(tsym, data.shape, 7)
    t_out, t_g, _ = _bind_run(tmx, tsym, data, params, is_train)
    j_out, j_g, _ = _bind_run(jmx, jsym, data, params, is_train)
    _close(t_out, j_out)
    for n in t_g:
        _close(t_g[n], j_g[n], n)


def test_the_ports_inference_reads_the_layouts_channel_axis():
    data_shape = (2, 6, 6, 3)
    j = jmx.sym.Convolution(jmx.sym.Variable("data"), kernel=(3, 3),
                            num_filter=4, layout="NHWC", name="c")
    with pytest.raises(Exception):
        j.infer_shape(data=data_shape)
    t = tmx.sym.Convolution(tmx.sym.Variable("data"), kernel=(3, 3),
                            num_filter=4, layout="NHWC", name="c")
    args, outs, _ = t.infer_shape(data=data_shape)
    assert args == [data_shape, (4, 3, 3, 3), (4,)]
    assert outs == [(2, 4, 4, 4)]
    g = tmx.sym.Convolution(tmx.sym.Variable("data"), kernel=(1,),
                            num_filter=6, num_group=3, layout="NWC")
    assert g.infer_shape(data=(2, 5, 3))[0][1] == (6, 1, 1)


@pytest.mark.parametrize("is_train", [False, True])
def test_nhwc_graph_equals_the_nchw_graph_at_h_not_c(is_train):
    data = np.random.RandomState(8).randn(2, 8, 6, 3).astype(np.float32)
    nhwc, nchw = _nhwc_graph(tmx, "NHWC"), _nhwc_graph(tmx, "NCHW")
    nchw_data = np.ascontiguousarray(data.transpose(0, 3, 1, 2))
    params = _params(nchw, nchw_data.shape, 9)
    assert _params(nhwc, data.shape, 9).keys() == params.keys()
    for n, s in zip(nhwc.list_arguments(),
                    nhwc.infer_shape(data=data.shape)[0]):
        assert n == "data" or s == params[n].shape
    c_out, c_g, _ = _bind_run(tmx, nchw, nchw_data, params, is_train)
    h_out, h_g, ex = _bind_run(tmx, nhwc, data, params, is_train)
    _close(h_out, c_out)
    for n in c_g:
        want = c_g[n].transpose(0, 2, 3, 1) if n == "data" else c_g[n]
        _close(h_g[n], want, n)
    if is_train:
        for n in ("b1_moving_mean", "b1_moving_var"):
            assert ex.aux_dict[n].shape == (4,)
