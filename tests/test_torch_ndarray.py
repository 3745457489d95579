"""The PyTorch port's op registry, its ops (the ResNet set, the
elementwise, shape, reduction, init and SGD ops), NDArray, autograd,
random and the initializers (`mxtpu_torch/ops/`, `mxtpu_torch/ndarray/`,
`autograd.py`, `random.py`, `initializer.py`) against the JAX package's
(`mxtpu/ops/`, `mxtpu/ndarray/`...).

Every op runs on the same numpy inputs in both packages; its forward and
its gradient (for a random cotangent on every output, through
`jax.vjp` of the `mxtpu` op and `torch.autograd.grad` of the port's) are
held together at float32's bound: rtol 1e-4 and atol 1e-5 times the
largest magnitude of the reference value.  Random draws differ between
the packages by design, so the initializers are held to their
distributions instead.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxtpu as jmx
from mxtpu.ops import registry as jreg
import mxtpu_torch as tmx
from mxtpu_torch.base import MXNetError
from mxtpu_torch.ops import registry as treg

RTOL, ATOL = 1e-4, 1e-5


def _close(got, want, what):
    want = np.asarray(want, dtype=np.float64)
    got = np.asarray(got, dtype=np.float64)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * scale,
                               err_msg=what)


def _both(name, inputs, attrs, grad=True, seed=1):
    """Run op ``name`` in both packages on numpy ``inputs``; check the
    outputs and, with ``grad``, every input's gradient."""
    jf = lambda *a: jreg.get_op(name).fn(*a, **attrs)  # noqa: E731
    jx = [jnp.asarray(x) for x in inputs]
    tx = [torch.tensor(x, requires_grad=grad
                       and np.issubdtype(x.dtype, np.floating))
          for x in inputs]
    tout = treg.invoke(treg.get_op(name), tx, dict(attrs))
    if not grad:
        jout = jf(*jx)
        jout = jout if isinstance(jout, tuple) else (jout,)
        assert len(jout) == len(tout)
        for j, t in zip(jout, tout):
            _close(t.detach().numpy(), j, "%s forward" % name)
        return
    jout, vjp = jax.vjp(jf, *jx)
    multi = isinstance(jout, tuple)
    jout = jout if multi else (jout,)
    assert len(jout) == len(tout)
    for j, t in zip(jout, tout):
        _close(t.detach().numpy(), j, "%s forward" % name)
    rng = np.random.RandomState(seed)
    cots = [np.asarray(rng.randn(*np.shape(j)), np.float32) for j in jout]
    jg = vjp(tuple(jnp.asarray(c) for c in cots) if multi
             else jnp.asarray(cots[0]))
    want = [i for i, t in enumerate(tx) if t.requires_grad]
    tg = torch.autograd.grad(list(tout), [tx[i] for i in want],
                             [torch.tensor(c) for c in cots],
                             allow_unused=True)
    for i, g in zip(want, tg):
        got = np.zeros(inputs[i].shape) if g is None else g.numpy()
        _close(got, jg[i], "%s gradient of input %d" % (name, i))


def _rand(*shape, seed=0, low=None):
    rng = np.random.RandomState(seed + sum(shape))
    if low is not None:
        return rng.uniform(low, 1.0, shape).astype(np.float32)
    return rng.randn(*shape).astype(np.float32)


# ---------------------------------------------------------------------------
# the ResNet op set
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("attrs,shapes", [
    (dict(num_hidden=5), [(3, 2, 2, 3), (5, 12), (5,)]),
    (dict(num_hidden=5, no_bias=True), [(3, 12), (5, 12)]),
    (dict(num_hidden=4, flatten=False), [(2, 3, 6), (4, 6), (4,)]),
])
def test_fully_connected(attrs, shapes):
    _both("FullyConnected", [_rand(*s) for s in shapes], attrs)


@pytest.mark.parametrize("attrs,shapes", [
    (dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), num_filter=6,
          no_bias=True, layout="NCHW"), [(2, 4, 9, 9), (6, 4, 3, 3)]),
    (dict(kernel=(3, 3), pad=(1, 1), num_filter=6),
     [(2, 4, 7, 7), (6, 4, 3, 3), (6,)]),
    (dict(kernel=(1, 1), stride=(2, 2), num_filter=8, no_bias=True),
     [(2, 4, 8, 8), (8, 4, 1, 1)]),
    (dict(kernel=(3, 3), dilate=(2, 2), num_filter=6, num_group=2),
     [(2, 4, 9, 9), (6, 2, 3, 3), (6,)]),
    (dict(kernel=(3,), stride=(2,), pad=(1,), num_filter=5),
     [(2, 3, 11), (5, 3, 3), (5,)]),
])
def test_convolution(attrs, shapes):
    _both("Convolution", [_rand(*s) for s in shapes], attrs)


@pytest.mark.parametrize("attrs,shape", [
    (dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="max",
          pooling_convention="valid"), (2, 3, 10, 10)),
    (dict(kernel=(3, 3), stride=(2, 2), pool_type="max",
          pooling_convention="full"), (2, 3, 8, 8)),
    (dict(kernel=(2, 2), stride=(2, 2), pad=(1, 1), pool_type="max",
          pooling_convention="full"), (2, 3, 7, 7)),
    (dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg"),
     (2, 3, 9, 9)),
    (dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg",
          count_include_pad=False), (2, 3, 9, 9)),
    (dict(kernel=(3, 3), stride=(2, 2), pool_type="avg",
          pooling_convention="full", count_include_pad=False), (2, 3, 8, 8)),
    (dict(kernel=(2, 2), stride=(1, 1), pool_type="sum"), (2, 3, 5, 5)),
    (dict(kernel=(1, 1), global_pool=True, pool_type="avg"), (2, 3, 4, 5)),
    (dict(kernel=(1, 1), global_pool=True, pool_type="max"), (2, 3, 4, 5)),
])
def test_pooling(attrs, shape):
    _both("Pooling", [_rand(*shape)], attrs)


@pytest.mark.parametrize("fix_gamma", [True, False])
@pytest.mark.parametrize("mode", ["train", "inference", "global_stats"])
def test_batch_norm(fix_gamma, mode):
    c = 3
    x = _rand(4, c, 5, 5) * 2.0 + 0.5
    ins = [x, _rand(c, low=0.5), _rand(c), _rand(c), _rand(c, low=0.5)]
    attrs = dict(eps=1e-5, momentum=0.9, fix_gamma=fix_gamma,
                 is_train=mode != "inference",
                 use_global_stats=mode == "global_stats")
    _both("BatchNorm", ins, attrs)


def test_batch_norm_visible_outputs():
    op = treg.get_op("BatchNorm")
    assert op.n_outputs({}) == 3 and op.n_visible_outputs({}) == 1
    assert op.n_visible_outputs({"output_mean_var": True}) == 3
    assert op.train_aware and not op.needs_rng


@pytest.mark.parametrize("act", ["relu", "sigmoid", "tanh", "softrelu",
                                 "softsign"])
def test_activation(act):
    _both("Activation", [_rand(3, 4, 5)], dict(act_type=act))


@pytest.mark.parametrize("attrs", [
    dict(), dict(normalization="batch"), dict(grad_scale=0.5,
                                              normalization="valid"),
    dict(use_ignore=True, ignore_label=2.0, normalization="valid"),
    dict(multi_output=True),
])
def test_softmax_output_gradient_is_label_driven(attrs):
    """Forward softmax; the data's gradient is (p - onehot) scaled, for
    any head gradient (the random cotangent), and the label's is 0."""
    rng = np.random.RandomState(4)
    if attrs.get("multi_output"):
        data, label = _rand(3, 5, 4), rng.randint(0, 5, (3, 4))
    else:
        data, label = _rand(6, 5), rng.randint(0, 5, (6,))
    _both("SoftmaxOutput", [data, label.astype(np.float32)], attrs)


@pytest.mark.parametrize("attrs", [
    dict(normalization="valid"),
    dict(normalization="valid", use_ignore=True, ignore_label=-1.0),
    dict(use_ignore=True, ignore_label=-1.0, multi_output=True),
])
@pytest.mark.parametrize("labels", [[1, -1, 3, -1], [1, 7, 3, 0]])
def test_softmax_output_labels_outside_the_classes(attrs, labels):
    """A label outside [0, n_class) has a zero one-hot row, as
    jax.nn.one_hot gives: the gradient is p there (zero under
    use_ignore for the ignored label), never an error."""
    if attrs.get("multi_output"):
        data, label = _rand(2, 5, 2), np.array(labels).reshape(2, 2)
    else:
        data, label = _rand(4, 5), np.array(labels)
    _both("SoftmaxOutput", [data, label.astype(np.float32)], attrs)


# ---------------------------------------------------------------------------
# elementwise, shape, reduction, init, optimizer ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["elemwise_add", "_plus", "_add",
                                  "elemwise_sub", "elemwise_mul",
                                  "elemwise_div"])
def test_binary(name):
    _both(name, [_rand(3, 4), _rand(3, 4, low=0.5)], {})


@pytest.mark.parametrize("name", ["broadcast_add", "broadcast_mul",
                                  "broadcast_div"])
def test_broadcast(name):
    _both(name, [_rand(3, 4), _rand(1, 4, low=0.5)], {})


@pytest.mark.parametrize("name", ["_plus_scalar", "_minus_scalar",
                                  "_rminus_scalar", "_mul_scalar",
                                  "_div_scalar", "_rdiv_scalar"])
def test_scalar(name):
    _both(name, [_rand(3, 4, low=0.5)], dict(scalar=1.5))


@pytest.mark.parametrize("name,attrs,shape", [
    ("Flatten", {}, (2, 3, 4)),
    ("Reshape", dict(shape=(0, -1)), (2, 3, 4)),
    ("Reshape", dict(shape=(-3, -2)), (2, 3, 4)),
    ("Reshape", dict(shape=(-4, 1, -1, 0, 0)), (2, 3, 4)),
    ("transpose", {}, (2, 3, 4)),
    ("transpose", dict(axes=(1, 0, 2)), (2, 3, 4)),
    ("sum", dict(axis=1), (2, 3, 4)),
    ("sum", {}, (2, 3, 4)),
    ("mean", dict(axis=(0, 2), keepdims=True), (2, 3, 4)),
    ("negative", {}, (2, 3)),
])
def test_shape_and_reduce(name, attrs, shape):
    _both(name, [_rand(*shape)], attrs)


@pytest.mark.parametrize("attrs", [dict(axis=1), dict(axis=0, keepdims=True),
                                   dict()])
def test_argmax(attrs):
    _both("argmax", [_rand(4, 6)], attrs, grad=False)


@pytest.mark.parametrize("name,attrs", [
    ("_zeros", dict(shape=(2, 3))), ("_ones", dict(shape=(4,))),
    ("_full", dict(shape=(2, 2), value=2.5)),
])
def test_init_ops(name, attrs):
    got = getattr(tmx.nd, name)(ctx=tmx.cpu(), **attrs).asnumpy()
    want = getattr(jmx.nd, name)(ctx=jmx.cpu(), **attrs).asnumpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32


@pytest.mark.parametrize("attrs", [
    dict(lr=0.1), dict(lr=0.1, wd=0.01, rescale_grad=0.25),
    dict(lr=0.05, rescale_grad=2.0, clip_gradient=0.5),
])
def test_sgd_update(attrs):
    w, g = _rand(3, 4), _rand(3, 4, seed=1)
    _both("sgd_update", [w, g], attrs, grad=False)


@pytest.mark.parametrize("attrs", [
    dict(lr=0.1, momentum=0.9),
    dict(lr=0.01, momentum=0.9, wd=1e-3, rescale_grad=1 / 32,
         clip_gradient=0.1),
])
def test_sgd_mom_update(attrs):
    w, g, m = _rand(3, 4), _rand(3, 4, seed=1), _rand(3, 4, seed=2)
    _both("sgd_mom_update", [w, g, m], attrs, grad=False)


@pytest.mark.parametrize("attrs", [
    dict(lr=0.01),
    dict(lr=0.05, beta1=0.8, beta2=0.99, epsilon=1e-6, wd=1e-2,
         rescale_grad=0.25, clip_gradient=0.5),
])
def test_adam_update(attrs):
    w, g = _rand(3, 4), _rand(3, 4, seed=1)
    m, v = _rand(3, 4, seed=2), _rand(3, 4, seed=3, low=0.0)
    _both("adam_update", [w, g, m, v], attrs, grad=False)


def test_registry_flags_match_the_reference():
    for name in ("FullyConnected", "Convolution", "Pooling", "BatchNorm",
                 "Activation", "SoftmaxOutput", "elemwise_add", "Flatten",
                 "Reshape", "transpose", "sum", "mean", "argmax", "_zeros",
                 "_ones", "_full", "sgd_update", "sgd_mom_update",
                 "_random_uniform", "_random_normal"):
        t, j = treg.get_op(name), jreg.get_op(name)
        for flag in ("differentiable", "needs_rng", "train_aware",
                     "mutate_inputs"):
            assert getattr(t, flag) == getattr(j, flag), (name, flag)
        assert t.n_outputs({}) == j.n_outputs({}), name
        assert t.n_visible_outputs({}) == j.n_visible_outputs({}), name
    for alias in ("_plus", "_add", "Convolution_v1", "Pooling_v1",
                  "BatchNorm_v1", "Softmax"):
        assert treg.get_op(alias) is treg.get_op(treg.get_op(alias).name)
    with pytest.raises(MXNetError, match="not registered"):
        treg.get_op("no_such_op")
    with pytest.raises(MXNetError, match="already registered"):
        treg.register("elemwise_add")(lambda a, b: a + b)


# ---------------------------------------------------------------------------
# NDArray
# ---------------------------------------------------------------------------

def _pair(a):
    return (tmx.nd.array(a, ctx=tmx.cpu()), jmx.nd.array(a, ctx=jmx.cpu()))


def test_ndarray_basics():
    a = _rand(2, 3)
    t, j = _pair(a)
    assert t.shape == j.shape and t.dtype == j.dtype == np.float32
    assert t.ndim == 2 and t.size == 6 and len(t) == 2
    assert t.ctx == tmx.cpu() and t.context == torch.device("cpu")
    np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())
    assert t.astype("int32").dtype == np.int32
    assert t.astype(np.float32, copy=False) is t
    same = t.astype(np.float32)
    same[:] = 0.0  # a copy, as the reference's: t keeps its values
    assert same is not t and t.asnumpy().any()
    c = t.copy()
    c[:] = 0.0
    assert t.asnumpy().any() and not c.asnumpy().any()
    dst = tmx.nd.zeros((2, 3), ctx=tmx.cpu())
    assert t.copyto(dst) is dst
    np.testing.assert_array_equal(dst.asnumpy(), a)
    assert t.as_in_context(tmx.cpu()) is t
    assert tmx.nd.array([1, 2], ctx=tmx.cpu()).dtype == np.float32
    assert float(tmx.nd.array([2.5], ctx=tmx.cpu())) == 2.5
    with pytest.raises(MXNetError, match="ambiguous"):
        bool(t)


def test_ndarray_operators_match_the_reference():
    a, b = _rand(3, 4), _rand(3, 4, low=0.5)
    (ta, ja), (tb, jb) = _pair(a), _pair(b)
    tr, jr = _pair(_rand(1, 4, low=0.5))
    for f in (lambda x, y, r: x + y, lambda x, y, r: x - y,
              lambda x, y, r: x * y, lambda x, y, r: x / y,
              lambda x, y, r: x + 2, lambda x, y, r: 2 - x,
              lambda x, y, r: 3 * x, lambda x, y, r: x / 4,
              lambda x, y, r: 1 / y, lambda x, y, r: -x,
              lambda x, y, r: x + r, lambda x, y, r: x * r,
              lambda x, y, r: x.reshape((4, 3)).transpose(),
              lambda x, y, r: x.transpose(1, 0).flatten(),
              lambda x, y, r: x.sum(axis=1), lambda x, y, r: x.mean(),
              lambda x, y, r: x.argmax(axis=1),
              lambda x, y, r: x[1], lambda x, y, r: x[:, 1:3]):
        _close(f(ta, tb, tr).asnumpy(), f(ja, jb, jr).asnumpy(), "operator")
    ta += tb
    ja += jb
    _close(ta.asnumpy(), ja.asnumpy(), "+=")
    ta[0] = 7.0
    ja[0] = 7.0
    _close(ta.asnumpy(), ja.asnumpy(), "setitem")


def test_nd_codegen_and_out():
    x = tmx.nd.array(_rand(2, 3), ctx=tmx.cpu())
    out = tmx.nd.zeros((2, 3), ctx=tmx.cpu())
    res = tmx.nd.elemwise_add(x, x, out=out)
    assert res is out
    _close(out.asnumpy(), 2 * x.asnumpy(), "out=")
    bn = tmx.nd.BatchNorm(x.reshape((2, 3, 1, 1)),
                          *[tmx.nd.ones((3,), ctx=tmx.cpu())] * 4,
                          output_mean_var=True)
    assert isinstance(bn, list) and len(bn) == 3


@pytest.mark.parametrize("req", ["write", "add"])
def test_autograd_record_and_backward(req):
    a, b = _rand(3, 4), _rand(3, 4, low=0.5)
    grads = []
    for mx in (tmx, jmx):
        x = mx.nd.array(a, ctx=mx.cpu())
        w = mx.nd.array(b, ctx=mx.cpu())
        x.attach_grad(grad_req=req)
        for _ in range(2):
            with mx.autograd.record():
                assert mx.autograd.is_recording()
                assert mx.autograd.is_training()
                y = mx.nd.FullyConnected(x * w + 1.0, w, num_hidden=3,
                                         no_bias=True)
                loss = (y * y).sum()
            loss.backward()
        grads.append(x.grad.asnumpy())
    _close(grads[0], grads[1], "gradient, grad_req=%s" % req)
    assert not tmx.autograd.is_recording()


def test_autograd_scopes_and_head_gradients():
    x = tmx.nd.array(_rand(2, 3), ctx=tmx.cpu())
    x.attach_grad()
    with tmx.autograd.record(train_mode=False):
        assert not tmx.autograd.is_training()
        with tmx.autograd.pause():
            assert not tmx.autograd.is_recording()
        with tmx.autograd.train_mode():
            assert tmx.autograd.is_training()
        y = x * 3.0
    g = tmx.nd.array(_rand(2, 3, seed=5), ctx=tmx.cpu())
    tmx.autograd.backward([y], [g])
    _close(x.grad.asnumpy(), 3 * g.asnumpy(), "head gradient")
    z = x * 2.0  # not recorded
    with pytest.raises(MXNetError, match="cannot differentiate"):
        z.backward()
    v = tmx.nd.zeros((2,), ctx=tmx.cpu())
    buf = tmx.nd.zeros((2,), ctx=tmx.cpu())
    tmx.autograd.mark_variables([v], [buf])
    with tmx.autograd.record():
        (v + 1.0).sum().backward()
    np.testing.assert_array_equal(buf.asnumpy(), [1.0, 1.0])


def test_save_and_load_read_each_other(tmp_path):
    a, b = _rand(2, 3), np.arange(4, dtype=np.int32)
    t_path, j_path = str(tmp_path / "t.params"), str(tmp_path / "j.params")
    tmx.nd.save(t_path, {"arg:w": tmx.nd.array(a, ctx=tmx.cpu()),
                         "aux:n": tmx.nd.array(b, ctx=tmx.cpu())})
    jmx.nd.save(j_path, {"arg:w": jmx.nd.array(a, ctx=jmx.cpu()),
                         "aux:n": jmx.nd.array(b, ctx=jmx.cpu())})
    for loaded in (jmx.nd.load(t_path), tmx.nd.load(j_path, ctx=tmx.cpu()),
                   tmx.nd.load(t_path, ctx=tmx.cpu())):
        assert list(loaded) == ["arg:w", "aux:n"]
        np.testing.assert_array_equal(loaded["arg:w"].asnumpy(), a)
        np.testing.assert_array_equal(loaded["aux:n"].asnumpy(), b)
        assert loaded["aux:n"].asnumpy().dtype == np.int32
    tmx.nd.save(t_path, [tmx.nd.array(a, ctx=tmx.cpu())])
    (back,) = jmx.nd.load(t_path)
    np.testing.assert_array_equal(back.asnumpy(), a)


def test_nightly_arrays_fixture_loads():
    """The JAX package's committed container of every dtype reads in
    the port (bfloat16 through ml_dtypes)."""
    import os

    fix = os.path.join(os.path.dirname(__file__), "nightly", "fixtures",
                       "v0.1.0")
    back = tmx.nd.load(os.path.join(fix, "arrays.params"), ctx=tmx.cpu())
    gold = np.load(os.path.join(fix, "arrays_gold.npz"))
    assert set(back) == set(gold.files)
    for k in gold.files:
        got = back[k].asnumpy()
        if gold[k].dtype == np.float64:  # the port keeps float64 sources
            got = got.astype(np.float64)  # as float32, as the JAX one does
        np.testing.assert_array_equal(got.astype(gold[k].dtype), gold[k])


# ---------------------------------------------------------------------------
# random and the initializers (by distribution)
# ---------------------------------------------------------------------------

def test_random_seed_reproduces_and_distributions():
    tmx.random.seed(7)
    a = tmx.random.uniform(-2.0, 3.0, shape=(200000,), ctx=tmx.cpu())
    b = tmx.random.normal(1.0, 2.0, shape=(200000,), ctx=tmx.cpu())
    tmx.random.seed(7)
    a2 = tmx.random.uniform(-2.0, 3.0, shape=(200000,), ctx=tmx.cpu())
    np.testing.assert_array_equal(a.asnumpy(), a2.asnumpy())
    u, n = a.asnumpy(), b.asnumpy()
    assert u.min() >= -2.0 and u.max() <= 3.0
    # mean 0.5, var 25/12; normal mean 1, var 4 (5 sigma of the estimate)
    assert abs(u.mean() - 0.5) < 5 * np.sqrt(25 / 12 / u.size)
    assert abs(u.var() / (25 / 12) - 1) < 0.02
    assert abs(n.mean() - 1.0) < 5 * 2 / np.sqrt(n.size)
    assert abs(n.var() / 4 - 1) < 0.02


@pytest.mark.parametrize("shape", [(256, 128, 3, 3), (1000, 512)])
def test_xavier_by_distribution(shape):
    """uniform(-s, s) with s = sqrt(3 / ((fan_in + fan_out) / 2)),
    hw_scale multiplying both fans; by range, mean and variance."""
    tmx.random.seed(0)
    arr = tmx.nd.zeros(shape, ctx=tmx.cpu())
    tmx.initializer.Xavier()(tmx.initializer.InitDesc("conv_weight"), arr)
    jarr = jmx.nd.zeros(shape, ctx=jmx.cpu())
    jmx.initializer.Xavier()(jmx.initializer.InitDesc("conv_weight"), jarr)
    hw = float(np.prod(shape[2:]))
    s = np.sqrt(3.0 / ((shape[1] * hw + shape[0] * hw) / 2.0))
    lim = np.float32(s)  # the limit as the float32 draw represents it
    for v in (arr.asnumpy(), jarr.asnumpy()):
        assert v.min() >= -lim and v.max() <= lim and v.max() > 0.99 * s
        assert abs(v.mean()) < 5 * s / np.sqrt(3 * v.size)
        assert abs(v.var() / (s * s / 3) - 1) < 0.02


def test_initializer_dispatch_by_name():
    init = tmx.initializer.Xavier()
    vals = {}
    for name in ("fc_weight", "fc_bias", "bn_gamma", "bn_beta",
                 "bn_moving_mean", "bn_moving_var"):
        arr = tmx.nd.full((4, 4), 5.0, ctx=tmx.cpu())
        init(tmx.initializer.InitDesc(name), arr)
        vals[name] = arr.asnumpy()
    assert np.all(vals["fc_bias"] == 0) and np.all(vals["bn_beta"] == 0)
    assert np.all(vals["bn_gamma"] == 1) and np.all(vals["bn_moving_var"] == 1)
    assert np.all(vals["bn_moving_mean"] == 0)
    assert np.all(np.abs(vals["fc_weight"]) <= np.sqrt(3.0 / 4))
    arr = tmx.nd.zeros((3,), ctx=tmx.cpu())
    tmx.initializer.Constant(2.0)(tmx.initializer.InitDesc(
        "x_weight", attrs={"__init__": tmx.initializer.Constant(
            3.0).dumps()}), arr)
    np.testing.assert_array_equal(arr.asnumpy(), [3.0, 3.0, 3.0])
    assert isinstance(tmx.initializer.create("normal"),
                      tmx.initializer.Normal)
