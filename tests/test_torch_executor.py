"""The PyTorch port's Executor (`mxtpu_torch/executor.py`) against the
JAX package's (`mxtpu/executor.py`): `simple_bind` and `bind`,
`forward` in inference and training, `backward` with ones and with given
head gradients, `grad_req` write/add/null, the BatchNorm moving-stat
fold, the mirror (remat) switch, `copy_params_from`, and the committed
nightly Module checkpoint.

Both executors get the same numpy arguments; outputs, gradients and aux
states are held together at float32's bound (rtol 1e-4, atol 1e-5 times
the largest magnitude of the reference value).
"""
import os

import numpy as np
import pytest
import torch

import mxtpu as jmx
from mxtpu import sym as jsym
import mxtpu_torch as tmx
from mxtpu_torch import sym as tsym
from mxtpu_torch.base import MXNetError

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
B = 4
FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "nightly",
                   "fixtures", "v0.1.0")


def _close(got, want, what):
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=RTOL,
                               atol=ATOL * scale, err_msg=what)


def _net(sym):
    """conv -> BN -> relu -> max pool -> residual add -> global avg pool
    -> FC -> SoftmaxOutput: every op of the ResNet set."""
    data = sym.Variable("data")
    c1 = sym.Convolution(data, kernel=(3, 3), pad=(1, 1), num_filter=4,
                         no_bias=True, name="c1")
    b1 = sym.BatchNorm(c1, fix_gamma=False, eps=1e-5, name="b1")
    r1 = sym.Activation(b1, act_type="relu", name="r1")
    p1 = sym.Pooling(r1, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                     pool_type="max", name="p1")
    c2 = sym.Convolution(p1, kernel=(3, 3), pad=(1, 1), num_filter=4,
                         name="c2")
    b2 = sym.BatchNorm(c2, name="b2")  # fix_gamma=True, eps=1e-3
    s = sym.elemwise_add(b2, p1, name="add")
    g = sym.Pooling(s, kernel=(1, 1), global_pool=True, pool_type="avg",
                    name="gp")
    fc = sym.FullyConnected(g, num_hidden=5, name="fc")
    return sym.SoftmaxOutput(fc, name="softmax")


def _values(sym, seed=0):
    rng = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = sym.infer_shape(data=(B, 3, 8, 8),
                                                softmax_label=(B,))
    args = {n: rng.randn(*s).astype(np.float32) * 0.5
            for n, s in zip(sym.list_arguments(), arg_shapes)}
    args["softmax_label"] = rng.randint(0, 5, (B,)).astype(np.float32)
    aux = {n: (rng.rand(*s).astype(np.float32) + 0.5)
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, aux


def _bind_both(grad_req="write"):
    t, j = _net(tsym), _net(jsym)
    args, aux = _values(j)
    execs = []
    for mx, s in ((tmx, t), (jmx, j)):
        ex = s.simple_bind(ctx=mx.cpu(), grad_req=grad_req,
                           data=(B, 3, 8, 8), softmax_label=(B,))
        ex.copy_params_from({k: mx.nd.array(v, ctx=mx.cpu())
                             for k, v in args.items()},
                            {k: mx.nd.array(v, ctx=mx.cpu())
                             for k, v in aux.items()})
        execs.append(ex)
    return execs


def _compare(te, je, grads=True):
    for a, b in zip(te.outputs, je.outputs):
        _close(a.asnumpy(), b.asnumpy(), "output")
    for n in je.aux_dict:
        _close(te.aux_dict[n].asnumpy(), je.aux_dict[n].asnumpy(), n)
    if grads:
        for n, g in je.grad_dict.items():
            if g is None:
                assert te.grad_dict[n] is None, n
            else:
                _close(te.grad_dict[n].asnumpy(), g.asnumpy(), n)


def test_simple_bind_matches_the_reference():
    te, je = _bind_both()
    assert te._grad_req == je._grad_req
    assert te.grad_dict["data"] is None and te.grad_dict["c1_weight"] \
        is not None
    assert [a.shape for a in te.arg_arrays] == [a.shape for a in
                                                je.arg_arrays]


@pytest.mark.parametrize("is_train", [False, True])
def test_forward(is_train):
    te, je = _bind_both()
    for ex in (te, je):
        ex.forward(is_train=is_train)
    _compare(te, je, grads=False)


def test_train_step_gradients_and_moving_stats():
    te, je = _bind_both()
    for _ in range(2):
        for ex in (te, je):
            ex.forward(is_train=True)
            ex.backward()
        _compare(te, je)


def test_backward_with_given_head_gradients():
    te, je = _bind_both()
    og = np.random.RandomState(3).randn(B, 5).astype(np.float32)
    for ex, mx in ((te, tmx), (je, jmx)):
        ex.forward(is_train=True)
        ex.backward(mx.nd.array(og, ctx=mx.cpu()))
    _compare(te, je)


def test_grad_req_add_accumulates():
    te, je = _bind_both(grad_req="add")
    for _ in range(2):
        for ex in (te, je):
            ex.forward(is_train=True)
            ex.backward()
    _compare(te, je)
    g1 = te.grad_dict["fc_weight"].asnumpy()
    te.forward(is_train=True)
    te.backward()
    assert np.linalg.norm(te.grad_dict["fc_weight"].asnumpy() - g1) > 0


def test_grad_req_null_and_errors():
    t = _net(tsym)
    req = {n: ("write" if n == "fc_weight" else "null")
           for n in t.list_arguments()}
    ex = t.simple_bind(ctx=tmx.cpu(), grad_req=req, data=(B, 3, 8, 8),
                       softmax_label=(B,))
    assert [n for n, g in ex.grad_dict.items() if g is not None] == \
        ["fc_weight"]
    with pytest.raises(MXNetError, match="before forward"):
        ex.backward()
    ex.forward(is_train=True)
    ex.backward()
    with pytest.raises(MXNetError, match="before forward"):
        ex.backward()
    with pytest.raises(MXNetError, match="unknown argument"):
        ex.forward(nothing=np.zeros(1))
    with pytest.raises(MXNetError, match="shape mismatch"):
        ex.forward(data=np.zeros((1, 3, 8, 8), np.float32))


def test_forward_kwargs_and_bind():
    t, j = _net(tsym), _net(jsym)
    args, aux = _values(j, seed=1)
    outs = []
    for mx, s in ((tmx, t), (jmx, j)):
        ex = s.bind(ctx=mx.cpu(),
                    args={k: mx.nd.array(v, ctx=mx.cpu())
                          for k, v in args.items()},
                    aux_states={k: mx.nd.array(v, ctx=mx.cpu())
                                for k, v in aux.items()})
        x = np.random.RandomState(2).randn(B, 3, 8, 8).astype(np.float32)
        outs.append(ex.forward(data=mx.nd.array(x, ctx=mx.cpu()))[0]
                    .asnumpy())
        assert ex.grad_dict["c1_weight"] is None
    _close(outs[0], outs[1], "bind + forward(data=...)")


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_mirror_keeps_the_gradients(monkeypatch, policy):
    """MXNET_BACKWARD_DO_MIRROR recomputes in the backward (through
    apply_remat); the gradients stay those of the plain executor."""
    te, _ = _bind_both()
    te.forward(is_train=True)
    te.backward()
    want = {n: g.asnumpy() for n, g in te.grad_dict.items() if g is not None}
    monkeypatch.setenv("MXNET_BACKWARD_DO_MIRROR", "1")
    monkeypatch.setenv("MXTPU_REMAT_POLICY", policy)
    tm, _ = _bind_both()
    tm.forward(is_train=True)
    tm.backward()
    for n, g in want.items():
        _close(tm.grad_dict[n].asnumpy(), g, "mirror " + n)


def test_nightly_module_checkpoint_reproduces():
    """The committed v0.1.0 Module checkpoint reproduces its recorded
    outputs in the port, at the bound tests/nightly holds mxtpu to."""
    symb, args, aux = tmx.model.load_checkpoint(os.path.join(FIX, "module"),
                                                1, ctx=tmx.cpu())
    io = np.load(os.path.join(FIX, "module_io.npz"))
    exe = symb.simple_bind(ctx=tmx.cpu(), grad_req="null",
                           data=tuple(io["x"].shape),
                           softmax_label=(io["x"].shape[0],))
    for k, v in args.items():
        v.copyto(exe.arg_dict[k])
    got = exe.forward(is_train=False, data=tmx.nd.array(io["x"],
                                                        ctx=tmx.cpu()))[0]
    np.testing.assert_allclose(got.asnumpy(), io["y"], rtol=1e-5, atol=1e-6)


def test_outputs_and_arrays_stay_shared():
    """Writes go into the bound arrays in place: a holder of an argument
    array sees the executor's aux and gradient updates."""
    te, _ = _bind_both()
    aux = te.aux_dict["b1_moving_mean"]
    grad = te.grad_dict["fc_bias"]
    ptr_a, ptr_g = aux._data.data_ptr(), grad._data.data_ptr()
    before = aux.asnumpy().copy()
    te.forward(is_train=True)
    te.backward()
    assert aux._data.data_ptr() == ptr_a and grad._data.data_ptr() == ptr_g
    assert not np.allclose(aux.asnumpy(), before)
    assert isinstance(te.outputs[0]._data, torch.Tensor)
    assert not te.outputs[0]._data.requires_grad
