"""The PyTorch port's CachedOp (`mxtpu_torch/cached_op.py`) and
hybridized tracing against the JAX package's: one graph run by both
CachedOps in inference and in training (outputs, gradients and the
moving statistics written back), the traced JSON of the ResNets and of
a hybridized block, `export` and `SymbolBlock.imports` across the
packages, `_contrib_flash_attention` through `nd`, `sym` and a
hybridized block, and Dropout by its distribution.

Inputs are drawn with numpy; outputs, gradients and moving statistics
must agree to a relative L2 of 1e-5 (a gradient zero in exact
arithmetic to 1e-5 of 1e-2 of its group's largest).  The
flash-attention op is run in the JAX package as
`tests/test_pallas_attention.py` runs it (Pallas in interpreter mode)
and held at that file's float32 bounds (rtol 2e-4, atol 2e-5); the
port takes the plain PyTorch version on the CPU.
"""
import json

import numpy as np
import pytest

import mxtpu as jmx
from mxtpu.cached_op import CachedOp as JCachedOp
from mxtpu.gluon.model_zoo import vision as jvision
import mxtpu_torch as tmx
from mxtpu_torch.base import MXNetError
from mxtpu_torch.cached_op import CachedOp as TCachedOp
from mxtpu_torch.gluon.model_zoo import vision as tvision
from test_torch_gluon import _build, _rel, _x
import torch

torch.set_num_threads(1)

TOL = 1e-5
F32_TOL = dict(rtol=2e-4, atol=2e-5)


def _graph(mx):
    """data -> FullyConnected -> BatchNorm -> relu -> FullyConnected,
    two outputs (the logits and the hidden layer)."""
    data = mx.sym.var("data")
    fc = mx.sym.FullyConnected(data, num_hidden=6, name="fc1")
    bn = mx.sym.BatchNorm(fc, fix_gamma=False, momentum=0.8, name="bn")
    act = mx.sym.relu(bn)
    return mx.sym.Group([mx.sym.FullyConnected(act, num_hidden=3,
                                               name="fc2"), act])


def _call(mx, op_cls, train, args, aux, head):
    """One call of a CachedOp over ``_graph`` on numpy ``args`` and
    ``aux``; under record() (training or not) with backward from
    ``head``.  Returns (outputs, argument gradients, aux after)."""
    sym = _graph(mx)
    op = op_cls(sym)
    arrs = [mx.nd.array(args[n], ctx=mx.cpu()) for n in sym.list_arguments()]
    auxs = [mx.nd.array(aux[n], ctx=mx.cpu())
            for n in sym.list_auxiliary_states()]
    for a in arrs:
        a.attach_grad()
    with mx.autograd.record(train_mode=train):
        outs = op(arrs, auxs)
    mx.autograd.backward(outs, [mx.nd.array(h, ctx=mx.cpu()) for h in head])
    with mx.autograd.predict_mode():
        again = op(arrs, auxs)  # not recorded: inference from the new aux
    return ([o.asnumpy() for o in outs] + [o.asnumpy() for o in again],
            [a.grad.asnumpy() for a in arrs], [a.asnumpy() for a in auxs])


@pytest.mark.parametrize("train", [True, False])
def test_cached_op_matches_the_reference(train):
    rng = np.random.RandomState(0)
    sym = _graph(tmx)
    shapes, _, aux_shapes = sym.infer_shape(data=(5, 4))
    args = {n: rng.normal(0, 1, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), shapes)}
    aux = {n: rng.uniform(0.5, 1.5, s).astype(np.float32)
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    head = [rng.normal(0, 1, (5, 3)).astype(np.float32),
            rng.normal(0, 1, (5, 6)).astype(np.float32)]
    want = _call(jmx, JCachedOp, train, args, aux, head)
    got = _call(tmx, TCachedOp, train, args, aux, head)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        # a gradient zero in exact arithmetic (fc1_bias, which the
        # BatchNorm follows) is rounding on both sides: its floor is
        # 1e-2 of the largest in its group
        floor = 1e-2 * max(np.linalg.norm(b) for b in w)
        for a, b in zip(g, w):
            assert a.shape == b.shape
            assert np.linalg.norm(a - b) <= TOL * max(np.linalg.norm(b),
                                                      floor)
    moved = not np.allclose(got[2][0], aux["bn_moving_mean"])
    assert moved == train  # written back only in training


def test_cached_op_checks_its_inputs():
    op = TCachedOp(_graph(tmx))
    with pytest.raises(MXNetError, match="expects 7 args"):
        op([tmx.nd.zeros((2, 4), ctx=tmx.cpu())])
    args = [tmx.nd.zeros(s, ctx=tmx.cpu()) for s in
            _graph(tmx).infer_shape(data=(2, 4))[0]]
    with pytest.raises(MXNetError, match="aux arrays"):
        op(args, [])
    with pytest.raises(MXNetError, match="not ported"):
        TCachedOp(_graph(tmx), [("shape_buckets", "pow2")])


@pytest.mark.parametrize("name", ["resnet18_v1", "resnet34_v1",
                                  "resnet101_v1", "resnet18_v2",
                                  "resnet50_v2"])
def test_traced_resnet_json_equals_the_reference(name):
    """resnet50_v1 is `test_torch_symbol.py`'s; the rest of the zoo."""
    res = []
    for mx, vision in ((jmx, jvision), (tmx, tvision)):
        with mx.sym.NameManager():
            net = vision.get_model(name, classes=10)
            out, out_fmt, in_fmt = net._trace_symbol(
                mx.nd.zeros((1, 3, 32, 32), ctx=mx.cpu()))
            res.append((json.loads(out.tojson()), out_fmt, in_fmt))
    assert res[1] == res[0]


def _twohead(mx):
    """A block with two inputs and two outputs: a conv layer and a BN,
    a Dense head, and the pooled features."""
    class TwoHead(mx.gluon.HybridBlock):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.conv = mx.gluon.nn.Conv2D(4, 3, padding=1)
                self.bn = mx.gluon.nn.BatchNorm()
                self.dense = mx.gluon.nn.Dense(2)

        def hybrid_forward(self, F, x, y):
            h = F.Activation(self.bn(self.conv(x)), act_type="relu")
            pooled = F.Pooling(h, global_pool=True, pool_type="avg",
                               kernel=(1, 1))
            return [self.dense(pooled) * y, F.Flatten(pooled)]

    return TwoHead()


def test_hybridized_block_traces_the_reference_graph_and_exports(tmp_path):
    x, y = _x(2, 3, 6, 6), _x(2, 1, seed=2)
    res = []
    for mx in (jmx, tmx):
        net = _build(mx, _twohead)
        net.initialize(mx.init.Xavier(), ctx=mx.cpu())
        net.hybridize()
        with mx.sym.NameManager():
            outs = net(mx.nd.array(x, ctx=mx.cpu()),
                       mx.nd.array(y, ctx=mx.cpu()))
        res.append((net, json.loads(net._cached_op.symbol.tojson()), outs))
    (jnet, jjson, _), (tnet, tjson, touts) = res
    assert tjson == jjson
    assert [o.shape for o in touts] == [(2, 2), (2, 4)]
    # the port's export, read by both packages' SymbolBlock.imports
    tnet.export(str(tmp_path / "twohead"), epoch=3)
    xs = [x, y]
    want = None
    for mx in (tmx, jmx):
        blk = mx.gluon.SymbolBlock.imports(
            str(tmp_path / "twohead-symbol.json"), ["data0", "data1"],
            str(tmp_path / "twohead-0003.params"), ctx=mx.cpu())
        with mx.autograd.predict_mode():
            got = [o.asnumpy() for o in blk(*[mx.nd.array(a, ctx=mx.cpu())
                                             for a in xs])]
        if want is None:
            with tmx.autograd.predict_mode():
                want = [o.asnumpy() for o in tnet(*[
                    tmx.nd.array(a, ctx=tmx.cpu()) for a in xs])]
        for a, b in zip(got, want):
            assert _rel(a, b) <= TOL
    with pytest.raises(MXNetError, match="before export"):
        _build(tmx, _twohead).export(str(tmp_path / "never"))


def test_hybridized_block_retraces_on_a_new_input_structure():
    net = _build(tmx, lambda m: m.gluon.nn.HybridLambda(
        lambda F, *xs: xs[0] * 2 if len(xs) == 1 else xs[0] + xs[1]))
    net.hybridize()
    one = tmx.nd.ones((2,), ctx=tmx.cpu())
    np.testing.assert_array_equal(net(one).asnumpy(), [2, 2])
    np.testing.assert_array_equal(net(one, one).asnumpy(), [2, 2])
    assert len(net._cached_op.symbol.list_arguments()) == 2


# ---------------------------------------------------------------------------
# _contrib_flash_attention
# ---------------------------------------------------------------------------

@pytest.fixture
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS_INTERPRET", "1")


@pytest.mark.parametrize("causal", [False, True])
def test_nd_contrib_flash_attention_matches_the_reference(causal,
                                                          _interpret_mode):
    rng = np.random.RandomState(1)
    q, k, v = (rng.normal(0, 1, (2, 3, 128, 32)).astype(np.float32)
               for _ in range(3))
    res = [mx.nd.contrib.flash_attention(
        *[mx.nd.array(a, ctx=mx.cpu()) for a in (q, k, v)],
        causal=causal).asnumpy() for mx in (jmx, tmx)]
    assert res[1].shape == (2, 3, 128, 32)
    np.testing.assert_allclose(res[1], res[0], **F32_TOL)


def test_flash_attention_op_through_sym_and_a_hybridized_block():
    """The registered op's gradient, through the symbol a hybridized
    block traces, equals the port's 3-D function's (which
    `test_torch_flash_backward.py` holds to the reference); a 4-D input
    whose heads were split by a transpose is handled as its copy."""
    import torch
    from mxtpu_torch.ops import flash_attention as tfa

    class Attention(tmx.gluon.HybridBlock):
        def hybrid_forward(self, F, q, k, v):
            return F.contrib.flash_attention(q, k, v, causal=True)

    rng = np.random.RandomState(2)
    # (batch 2, T 64, heads 2, d 16), heads moved to axis 1 by a
    # transpose: a strided 4-D view
    base = [rng.normal(0, 1, (2, 64, 2, 16)).astype(np.float32)
            for _ in range(3)]
    head = rng.normal(0, 1, (2, 2, 64, 16)).astype(np.float32)
    blk = Attention()
    blk.hybridize()
    arrs = [tmx.nd.array(a, ctx=tmx.cpu()).transpose(0, 2, 1, 3)
            for a in base]
    for a in arrs:
        a.attach_grad()
    with tmx.autograd.record():
        out = blk(*arrs)
    out.backward(tmx.nd.array(head, ctx=tmx.cpu()))
    ts = [torch.from_numpy(a.transpose(0, 2, 1, 3).reshape(4, 64, 16).copy())
          .requires_grad_() for a in base]
    want = tfa.flash_attention(*ts, causal=True)
    want.backward(torch.from_numpy(head.reshape(4, 64, 16)))
    np.testing.assert_allclose(out.asnumpy().reshape(4, 64, 16),
                               want.detach().numpy(), rtol=1e-6, atol=1e-6)
    for a, t in zip(arrs, ts):
        np.testing.assert_allclose(a.grad.asnumpy().reshape(4, 64, 16),
                                   t.grad.numpy(), rtol=1e-6, atol=1e-6)
    assert blk._cached_op.symbol.list_outputs() == \
        ["attention0_contrib_flash_attention0_output"]
    sym = tmx.sym.contrib.flash_attention(
        tmx.sym.var("q"), tmx.sym.var("k"), tmx.sym.var("v"))
    assert sym.infer_shape(q=(1, 2, 8, 16), k=(1, 2, 8, 16),
                           v=(1, 2, 8, 16))[1] == [(1, 2, 8, 16)]
    with pytest.raises(MXNetError, match="batch, heads, seq"):
        tmx.nd.contrib.flash_attention(*[tmx.nd.zeros((2, 8, 16),
                                                      ctx=tmx.cpu())] * 3)


# ---------------------------------------------------------------------------
# Dropout, by distribution
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mx", [jmx, tmx], ids=["reference", "port"])
def test_dropout_by_distribution(mx):
    """Training zeroes a share ``p`` of the elements (within 4 sigma) and
    scales the rest by 1 / (1 - p); ``axes`` draws one mask for each
    slice; predict mode is the identity; hybridized and imperative
    alike."""
    p, n = 0.3, 40000
    x = mx.nd.ones((n // 100, 100), ctx=mx.cpu())
    for hybridize in (False, True):
        blk = mx.gluon.nn.Dropout(p)
        if hybridize:
            blk.hybridize()
        with mx.autograd.record():
            out = blk(x).asnumpy()
        zeros = float((out == 0).mean())
        assert abs(zeros - p) <= 4 * np.sqrt(p * (1 - p) / n), zeros
        np.testing.assert_allclose(out[out != 0], 1 / (1 - p), rtol=1e-6)
        np.testing.assert_array_equal(blk(x).asnumpy(), x.asnumpy())
    with mx.autograd.train_mode():
        cols = mx.nd.Dropout(x, p=0.5, axes=(0,)).asnumpy()
    assert np.all((cols == 0).all(0) | (cols != 0).all(0))
    assert 0 < (cols[0] == 0).mean() < 1
