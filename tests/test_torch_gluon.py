"""The PyTorch port's gluon layers (`mxtpu_torch/gluon/nn/`) against
the JAX package's (`mxtpu/gluon/nn/`): every ported layer, forward and
gradient, imperative and hybridized; and the harness the loss and
block tests share (`test_torch_gluon_loss.py`,
`test_torch_gluon_block.py`).

Each block is built in both packages inside a fresh `NameManager` (so
the names agree), given the same parameters drawn with numpy, and run
on the same numpy inputs under `autograd.record()` with the same head
gradient.  Outputs, input gradients, parameter gradients and the
moving statistics must agree to a relative L2 of `TOL` (1e-5: float32
arithmetic in a few ops, summed in other orders); a parameter gradient
that is zero in exact arithmetic (a bias a BatchNorm follows) is held
to `TOL` of 1e-2 of the block's largest parameter gradient.  The
reference runs hybridized (one compiled program) once per case; the
port imperatively and hybridized.
"""
import numpy as np
import pytest

import mxtpu as jmx
import mxtpu_torch as tmx
from mxtpu_torch.base import MXNetError
from mxtpu_torch.gluon.parameter import load_numpy
import torch

torch.set_num_threads(1)

TOL = 1e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _build(mx, make):
    with mx.sym.NameManager():
        return make(mx)


def _run(mx, blk, inputs, head, extra=(), hybridize=False, train=True):
    """One recorded forward and backward of ``blk`` on ``inputs`` (numpy)
    with head gradient ``head``; returns (output, input gradients,
    {param: grad}, {param: value})."""
    if hybridize:
        blk.hybridize()
    xs = [mx.nd.array(x, ctx=mx.cpu()) for x in inputs]
    for x in xs:
        x.attach_grad()
    ex = [None if e is None else mx.nd.array(e, ctx=mx.cpu()) for e in extra]
    with mx.autograd.record(train_mode=train):
        out = blk(*xs, *ex)
    out.backward(mx.nd.array(head, ctx=mx.cpu()))
    params = blk.collect_params()
    return (out.asnumpy(), [x.grad.asnumpy() for x in xs],
            {k: p.grad().asnumpy() for k, p in params.items()
             if p.grad_req != "null"},
            {k: p.data().asnumpy() for k, p in params.items()})


_REFERENCE = {}


def _parity(make, inputs, extra=(), hybridize=False, train=True, seed=0,
            tol=TOL, key=None):
    """``make(mx)`` built in both packages from the same random
    parameters, run by ``_run`` with the same random head gradient;
    every result within ``tol``.  The reference runs hybridized, once
    per ``key`` (its imperative run computes the same function); the
    port as asked.  Returns the port's results."""
    if key is None or key not in _REFERENCE:
        rng = np.random.RandomState(seed)
        jb = _build(jmx, make)
        jb.initialize(ctx=jmx.cpu())
        jin = [jmx.nd.array(x, ctx=jmx.cpu()) for x in inputs] + [
            None if e is None else jmx.nd.array(e, ctx=jmx.cpu())
            for e in extra]
        with jmx.autograd.pause():  # infers the deferred shapes
            shape = jb(*jin).shape
        arrays = {}
        for k, p in jb.collect_params().items():
            arrays[k] = (rng.uniform(0.5, 1.5, p.shape) if k.endswith("_var")
                         else rng.normal(0, 0.5, p.shape)).astype(np.float32)
            p.set_data(jmx.nd.array(arrays[k], ctx=jmx.cpu()))
        head = rng.normal(0, 1, shape).astype(np.float32)
        _REFERENCE[key] = (arrays, head,
                           _run(jmx, jb, inputs, head, extra, True, train))
    arrays, head, j = _REFERENCE[key]
    tb = _build(tmx, make)
    tb.initialize(ctx=tmx.cpu())
    load_numpy(tb.collect_params(), arrays)
    t = _run(tmx, tb, inputs, head, extra, hybridize, train)
    assert t[0].shape == j[0].shape
    assert _rel(t[0], j[0]) <= tol, ("output", _rel(t[0], j[0]))
    for a, b in zip(t[1], j[1]):
        assert _rel(a, b) <= tol, ("input grad", _rel(a, b))
    assert set(t[2]) == set(j[2]) and set(t[3]) == set(j[3])
    # a gradient zero in exact arithmetic (a bias a BatchNorm follows)
    # is rounding on both sides: its floor is 1e-2 of the largest
    floor = 1e-2 * max([np.linalg.norm(g) for g in j[2].values()] + [0])
    for k in j[2]:
        err = np.linalg.norm(t[2][k] - j[2][k].astype(np.float64))
        assert err <= tol * max(np.linalg.norm(j[2][k]), floor), (k, err)
    for k in j[3]:
        assert _rel(t[3][k], j[3][k]) <= tol, (k, _rel(t[3][k], j[3][k]))
    return t


def _x(*shape, seed=1):
    return np.random.RandomState(seed).normal(0, 1, shape).astype(np.float32)


LAYERS = {
    "dense": (lambda mx: mx.gluon.nn.Dense(5, activation="tanh"), [(3, 4, 2)]),
    "dense_no_flatten": (lambda mx: mx.gluon.nn.Dense(
        5, use_bias=False, flatten=False, in_units=2), [(3, 4, 2)]),
    "conv1d": (lambda mx: mx.gluon.nn.Conv1D(4, 3, strides=2, padding=1,
                                             dilation=1), [(2, 3, 9)]),
    "conv2d": (lambda mx: mx.gluon.nn.Conv2D(
        6, (3, 2), strides=(1, 2), padding=(1, 0), dilation=(2, 1),
        groups=2, activation="relu"), [(2, 4, 7, 6)]),
    "conv3d": (lambda mx: mx.gluon.nn.Conv3D(2, 2, use_bias=False),
               [(1, 3, 4, 4, 4)]),
    "maxpool1d": (lambda mx: mx.gluon.nn.MaxPool1D(3, 2, 1), [(2, 3, 9)]),
    "maxpool2d_ceil": (lambda mx: mx.gluon.nn.MaxPool2D(
        (3, 2), ceil_mode=True), [(2, 3, 7, 6)]),
    "maxpool3d": (lambda mx: mx.gluon.nn.MaxPool3D(), [(1, 2, 4, 4, 4)]),
    "avgpool1d": (lambda mx: mx.gluon.nn.AvgPool1D(2), [(2, 3, 8)]),
    "avgpool2d_no_pad_count": (lambda mx: mx.gluon.nn.AvgPool2D(
        3, 2, 1, count_include_pad=False), [(2, 3, 7, 7)]),
    "avgpool3d": (lambda mx: mx.gluon.nn.AvgPool3D(2, ceil_mode=True),
                  [(1, 2, 5, 5, 5)]),
    "global_max_1d": (lambda mx: mx.gluon.nn.GlobalMaxPool1D(), [(2, 3, 5)]),
    "global_max_2d": (lambda mx: mx.gluon.nn.GlobalMaxPool2D(),
                      [(2, 3, 4, 5)]),
    "global_max_3d": (lambda mx: mx.gluon.nn.GlobalMaxPool3D(),
                      [(1, 2, 3, 4, 5)]),
    "global_avg_1d": (lambda mx: mx.gluon.nn.GlobalAvgPool1D(), [(2, 3, 5)]),
    "global_avg_2d": (lambda mx: mx.gluon.nn.GlobalAvgPool2D(),
                      [(2, 3, 4, 5)]),
    "global_avg_3d": (lambda mx: mx.gluon.nn.GlobalAvgPool3D(),
                      [(1, 2, 3, 4, 5)]),
    "batchnorm": (lambda mx: mx.gluon.nn.BatchNorm(), [(4, 3, 5, 5)]),
    "batchnorm_no_scale_center_axis": (lambda mx: mx.gluon.nn.BatchNorm(
        axis=-1, momentum=0.7, epsilon=1e-3, scale=False, center=False),
        [(6, 5)]),
    "batchnorm_global_stats": (lambda mx: mx.gluon.nn.BatchNorm(
        use_global_stats=True, in_channels=3), [(4, 3, 2, 2)]),
    "flatten": (lambda mx: mx.gluon.nn.Flatten(), [(2, 3, 4)]),
    "dropout_zero": (lambda mx: mx.gluon.nn.Dropout(0.0), [(3, 4)]),
    "hybrid_lambda_name": (lambda mx: mx.gluon.nn.HybridLambda("relu"),
                           [(3, 4)]),
    "hybrid_lambda_fn": (lambda mx: mx.gluon.nn.HybridLambda(
        lambda F, x: F.Activation(x, act_type="softsign") * 2), [(3, 4)]),
    "sequential": (lambda mx: _seq(mx), [(2, 3, 8, 8)]),
}
for _act in ("relu", "sigmoid", "tanh", "softrelu", "softsign"):
    LAYERS["activation_" + _act] = (
        lambda mx, a=_act: mx.gluon.nn.Activation(a), [(3, 5)])
# the transposed convolutions (deferred in_channels), the
# padding, norm and activation layers
LAYERS.update({
    "conv1d_transpose": (lambda mx: mx.gluon.nn.Conv1DTranspose(
        4, 3, strides=2, padding=1, output_padding=1), [(2, 3, 5)]),
    "conv2d_transpose": (lambda mx: mx.gluon.nn.Conv2DTranspose(
        6, (3, 2), strides=(2, 1), padding=(1, 0), output_padding=(1, 0),
        dilation=(1, 2), groups=2, activation="relu"), [(2, 4, 4, 5)]),
    "conv3d_transpose": (lambda mx: mx.gluon.nn.Conv3DTranspose(
        2, 2, strides=2, use_bias=False), [(1, 3, 2, 3, 2)]),
    "reflection_pad2d": (lambda mx: mx.gluon.nn.ReflectionPad2D(2),
                         [(2, 3, 5, 6)]),
    "layernorm": (lambda mx: mx.gluon.nn.LayerNorm(), [(3, 4, 5)]),
    "layernorm_axis1": (lambda mx: mx.gluon.nn.LayerNorm(
        axis=1, epsilon=1e-3, center=False, in_channels=4), [(3, 4, 5)]),
    "instancenorm": (lambda mx: mx.gluon.nn.InstanceNorm(scale=True),
                     [(2, 3, 4, 5)]),
    "instancenorm_default": (lambda mx: mx.gluon.nn.InstanceNorm(),
                             [(2, 3, 4)]),
    "leaky_relu": (lambda mx: mx.gluon.nn.LeakyReLU(0.1), [(3, 5)]),
    "prelu": (lambda mx: mx.gluon.nn.PReLU(), [(2, 3, 4)]),
    "elu": (lambda mx: mx.gluon.nn.ELU(0.7), [(3, 5)]),
    "selu": (lambda mx: mx.gluon.nn.SELU(), [(3, 5)]),
    "gelu": (lambda mx: mx.gluon.nn.GELU(), [(3, 5)]),
    "swish": (lambda mx: mx.gluon.nn.Swish(1.5), [(3, 5)]),
})

# gluon.contrib's layers, and a block whose hybrid_forward loops with
# F.contrib.foreach (run by test_torch_gluon_contrib.py, to keep this
# file under 30 s)
CONTRIB_LAYERS = {
    "contrib_concurrent": (lambda mx: _concurrent(mx, False),
                           [(2, 3, 4)]),
    "contrib_hybrid_concurrent": (lambda mx: _concurrent(mx, True),
                                  [(2, 3, 4)]),
    "contrib_identity": (lambda mx: mx.gluon.contrib.nn.Identity(),
                         [(3, 4)]),
    "contrib_sync_batchnorm": (lambda mx: mx.gluon.contrib.nn.SyncBatchNorm(
        num_devices=1, momentum=0.8), [(4, 3, 2, 2)]),
    "contrib_pixel_shuffle2d": (lambda mx: mx.gluon.contrib.nn.PixelShuffle2D(
        (2, 3)), [(2, 12, 3, 2)]),
    "foreach_rnn_block": (lambda mx: _foreach_block(mx), [(4, 2, 3)]),
}


def _concurrent(mx, hybrid):
    nn = mx.gluon.contrib.nn
    net = nn.HybridConcurrent() if hybrid else nn.Concurrent()
    with net.name_scope():
        net.add(mx.gluon.nn.Dense(5, flatten=False), nn.Identity(),
                mx.gluon.nn.Activation("tanh"))
    return net


def _foreach_block(mx):
    class ForeachRNN(mx.gluon.HybridBlock):
        """An Elman RNN over axis 0 of its (T, N, C) input."""

        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.i2h = mx.gluon.nn.Dense(4, in_units=3, flatten=False)
                self.h2h = mx.gluon.nn.Dense(4, in_units=4, flatten=False)

        def hybrid_forward(self, F, x):
            def step(xt, h):
                hn = F.tanh(self.i2h(xt) + self.h2h(h))
                return hn, hn
            h0 = F.zeros_like(F.slice_axis(self.i2h(x), axis=0, begin=0,
                                           end=1)).reshape((-3, 0))
            outs, _ = F.contrib.foreach(step, x, h0)
            return outs

    return ForeachRNN()


def _seq(mx):
    net = mx.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(mx.gluon.nn.Conv2D(4, 3, padding=1), mx.gluon.nn.BatchNorm(),
                mx.gluon.nn.Activation("relu"), mx.gluon.nn.MaxPool2D(),
                mx.gluon.nn.Dense(3))
    return net


@pytest.mark.parametrize("hybridize", [False, True])
@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_the_reference(name, hybridize):
    make, shapes = LAYERS[name]
    _parity(make, [_x(*s, seed=i + 1) for i, s in enumerate(shapes)],
            hybridize=hybridize, key=("layer", name))


@pytest.mark.parametrize("hybridize", [False, True])
def test_batchnorm_in_predict_mode_uses_and_keeps_the_moving_stats(
        hybridize):
    t = _parity(lambda mx: mx.gluon.nn.BatchNorm(in_channels=3),
                [_x(4, 3, 2, 2)], hybridize=hybridize, train=False,
                key="bn_predict")
    assert not np.allclose(t[3]["batchnorm0_running_var"], 1.0)


def test_lambda_block_runs_an_nd_function():
    for name, fn in (("relu", np.maximum), ("exp", None)):
        blk = tmx.gluon.nn.Lambda(name)
        x = _x(3, 4)
        got = blk(tmx.nd.array(x, ctx=tmx.cpu())).asnumpy()
        want = np.maximum(x, 0) if fn else np.exp(x)
        np.testing.assert_allclose(got, want, rtol=1e-6)
    with pytest.raises(MXNetError):
        tmx.gluon.nn.Lambda("no_such_function")
