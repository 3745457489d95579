"""The PyTorch port's recurrent op and its neighbours against the JAX
package's, on the CPU.

* ``RNN`` (``mxtpu_torch/ops/rnn_op.py``) in its four modes, one and
  two directions, one and two layers, with and without
  ``state_outputs``: the registered op (``nd.RNN``, the plain loop on
  the CPU) and the fused version (``rnn_fused``, torch's fused RNN,
  whose CPU kernel runs here and whose cuDNN kernel runs on the card),
  forward and the gradients with respect to the data, the flat
  parameters and the states, against ``mxtpu``'s op through
  ``jax.vjp``, to a relative L2 of ``TOL`` (1e-5: float32 sums in
  other orders over a few steps).
* ``rnn_param_size``; ``Embedding`` (clipped ids, the weight's
  gradient); the shape ops the recurrent paths use.
* The dropout between layers, by distribution (the draws differ from
  the JAX package's).
* TF32 off (ROADMAP C4): at the moment of the library call, raw
  ``nd.Convolution``, ``nd.FullyConnected`` and ``nd.RNN`` (and the
  same ops under an executor and a CachedOp) see both TF32 flags off,
  though the process set them on.
"""
import jax
import numpy as np
import pytest
import torch

import mxtpu as jmx
import mxtpu_torch as tmx
from mxtpu.ops import rnn_op as jrnn
from mxtpu_torch.base import MXNetError
from mxtpu_torch.ops import nn as tnn
from mxtpu_torch.ops import rnn_op as trnn

torch.set_num_threads(1)

TOL = 1e-5
T, N, C, H = 4, 3, 5, 6


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _case(mode, bi, layers, seed=0):
    """Data, flat parameters, states and (for the LSTM) cells."""
    rng = np.random.RandomState(seed)
    d = 2 if bi else 1
    size = jrnn.rnn_param_size(C, H, layers, bi, mode)
    arrays = [rng.normal(0, 1, (T, N, C)), rng.normal(0, 0.3, (size,)),
              rng.normal(0, 1, (layers * d, N, H))]
    if mode == "lstm":
        arrays.append(rng.normal(0, 1, (layers * d, N, H)))
    return [a.astype(np.float32) for a in arrays]


_REFERENCE = {}


def _reference(mode, bi, layers):
    """mxtpu's op with its final states and its vjp for random head
    gradients, once per configuration: (inputs, heads, outputs, input
    gradients, input gradients with zero heads on the states)."""
    key = (mode, bi, layers)
    if key not in _REFERENCE:
        inputs = _case(mode, bi, layers)
        attrs = dict(state_size=H, num_layers=layers, bidirectional=bi,
                     mode=mode, state_outputs=True)

        def op(*args):
            return jrnn._rnn(None, *args, **attrs)

        @jax.jit  # one program: op by op, the scan's ops compile one by one
        def run(args, heads):
            outs, vjp = jax.vjp(op, *args)
            zeros = tuple(jax.numpy.zeros_like(h) for h in heads[1:])
            return outs, vjp(heads), vjp((heads[0],) + zeros)

        rng = np.random.RandomState(1)
        heads = tuple(rng.normal(0, 1, o.shape).astype(np.float32)
                      for o in jax.eval_shape(op, *inputs))
        outs, grads, out_only = run(tuple(inputs), heads)
        _REFERENCE[key] = (inputs, list(heads),
                           [np.asarray(o) for o in outs],
                           [np.asarray(g) for g in grads],
                           [np.asarray(g) for g in out_only])
    return _REFERENCE[key]


CASES = [(mode, bi, layers, so) for mode in ("lstm", "gru", "rnn_tanh",
                                             "rnn_relu")
         for bi in (False, True) for layers in (1, 2) for so in (False, True)]


@pytest.mark.parametrize("mode,bi,layers,state_outputs", CASES)
def test_rnn_op_matches_the_reference(mode, bi, layers, state_outputs):
    inputs, heads, want_out, grads, out_only = _reference(mode, bi, layers)
    if not state_outputs:
        heads, want_out, want_grad = heads[:1], want_out[:1], out_only
    else:
        want_grad = grads
    # the registered op, imperatively (the plain loop on the CPU)
    xs = [tmx.nd.array(a, ctx=tmx.cpu()) for a in inputs]
    for x in xs:
        x.attach_grad()
    with tmx.autograd.record():
        out = tmx.nd.RNN(*xs, state_size=H, num_layers=layers,
                         bidirectional=bi, mode=mode,
                         state_outputs=state_outputs)
    outs = out if isinstance(out, list) else [out]
    assert len(outs) == len(want_out)
    tmx.autograd.backward(outs, [tmx.nd.array(h, ctx=tmx.cpu())
                                 for h in heads])
    for got, want in zip(outs, want_out):
        assert _rel(got.asnumpy(), want) <= TOL
    for x, want in zip(xs, want_grad):
        assert _rel(x.grad.asnumpy(), want) <= TOL
    # the fused version, as the card runs it (torch's CPU kernel here)
    ts = [torch.tensor(a, requires_grad=True) for a in inputs]
    x, h, c = trnn.rnn_fused(ts[0], ts[1], ts[2],
                             ts[3] if mode == "lstm" else None, H, layers,
                             bi, mode)
    fused = [x, h, c][:len(want_out)]
    for got, want in zip(fused, want_out):
        assert _rel(got.detach().numpy(), want) <= TOL
    torch.autograd.backward(fused, [torch.tensor(g) for g in heads])
    for t, want in zip(ts, want_grad):
        # without state_outputs, the states reach only the outputs
        assert _rel(t.grad.numpy(), want) <= TOL


def test_rnn_param_size_matches_the_reference():
    for mode in ("lstm", "gru", "rnn_tanh", "rnn_relu"):
        for bi in (False, True):
            for layers in (1, 2, 3):
                for c, h in ((1, 1), (7, 5), (650, 650)):
                    assert trnn.rnn_param_size(c, h, layers, bi, mode) == \
                        jrnn.rnn_param_size(c, h, layers, bi, mode)


def test_rnn_op_raises_on_what_it_does_not_port():
    x, w, h, c = [tmx.nd.array(a, ctx=tmx.cpu())
                  for a in _case("lstm", False, 1)]
    for attrs in ({"projection_size": 3}, {"lstm_state_clip_min": -1.0},
                  {"lstm_state_clip_max": 1.0},
                  {"lstm_state_clip_nan": True}, {"mode": "elman"}):
        kwargs = dict(state_size=H, num_layers=1, mode="lstm")
        kwargs.update(attrs)
        with pytest.raises(MXNetError):
            tmx.nd.RNN(x, w, h, c, **kwargs)
    with pytest.raises(MXNetError, match="parameters given"):
        tmx.nd.RNN(x, w[:-1], h, c, state_size=H, num_layers=1)
    with pytest.raises(MXNetError, match="state_cell"):
        tmx.nd.RNN(x, w, h, state_size=H, num_layers=1, mode="lstm")


def _identity_relu_params(layers):
    """rnn_relu weights making each layer relu(its input): W_x = I,
    W_h = 0, biases 0 (C == H)."""
    ws, bs = [], []
    for _ in range(layers):
        ws += [np.eye(H), np.zeros((H, H))]
        bs += [np.zeros(H), np.zeros(H)]
    return np.concatenate([a.reshape(-1) for a in ws + bs]).astype(
        np.float32)


@pytest.mark.parametrize("run", ["op", "fused"])
def test_dropout_between_layers_by_distribution(run):
    """Two identity layers over positive data: the output over the
    data is 0 (dropped) or 1 / (1 - p) (kept), the kept share near
    1 - p, in training; the data itself outside training."""
    p, n, t = 0.3, 400, 5
    rng = np.random.RandomState(0)
    x = rng.uniform(0.5, 1.5, (t, n, H)).astype(np.float32)
    w = _identity_relu_params(2)
    h0 = np.zeros((2, n, H), np.float32)
    tmx.random.seed(3)

    def call(train):
        if run == "op":
            args = [tmx.nd.array(a, ctx=tmx.cpu()) for a in (x, w, h0)]
            with tmx.autograd.train_mode() if train else \
                    tmx.autograd.predict_mode():
                out = tmx.nd.RNN(*args, state_size=H, num_layers=2,
                                 mode="rnn_relu", p=p)
            return out.asnumpy()
        gen = tmx.random.generator(torch.device("cpu"))
        out = trnn.rnn_fused(torch.tensor(x), torch.tensor(w),
                             torch.tensor(h0), None, H, 2, False,
                             "rnn_relu", p=p, is_train=train, gen=gen)[0]
        return out.detach().numpy()

    ratio = call(True) / x
    kept = ratio != 0
    np.testing.assert_allclose(ratio[kept], 1.0 / (1 - p), rtol=1e-6)
    share = kept.mean()
    # 12,000 draws: the share's standard deviation is 0.0042
    assert abs(share - (1 - p)) < 0.02, share
    assert np.array_equal(call(False), x)
    # the last layer's output is never dropped: one layer keeps all
    args = [tmx.nd.array(a, ctx=tmx.cpu())
            for a in (x, _identity_relu_params(1), h0[:1])]
    with tmx.autograd.train_mode():
        out = tmx.nd.RNN(*args, state_size=H, num_layers=1,
                         mode="rnn_relu", p=p)
    assert np.array_equal(out.asnumpy(), x)


def test_embedding_matches_the_reference():
    rng = np.random.RandomState(0)
    vocab, dim = 7, 4
    weight = rng.normal(0, 1, (vocab, dim)).astype(np.float32)
    # out-of-range ids are clipped, float ids truncated
    ids = np.array([[0, 3, 6], [-3, 9, 2.7]], np.float32)
    head = rng.normal(0, 1, ids.shape + (dim,)).astype(np.float32)
    out, vjp = jax.vjp(
        lambda w: jmx.ops.registry.get_op("Embedding").fn(
            jax.numpy.asarray(ids), w, input_dim=vocab, output_dim=dim),
        jax.numpy.asarray(weight))
    (want_grad,) = vjp(jax.numpy.asarray(head))
    w = tmx.nd.array(weight, ctx=tmx.cpu())
    w.attach_grad()
    with tmx.autograd.record():
        got = tmx.nd.Embedding(tmx.nd.array(ids, ctx=tmx.cpu()), w,
                               input_dim=vocab, output_dim=dim)
    got.backward(tmx.nd.array(head, ctx=tmx.cpu()))
    assert np.array_equal(got.asnumpy(), np.asarray(out))
    assert _rel(w.grad.asnumpy(), want_grad) <= TOL
    # sparse_grad: the same output, and the same gradient once densified
    w.attach_grad(stype="row_sparse")
    with tmx.autograd.record():
        got = tmx.nd.Embedding(tmx.nd.array(ids, ctx=tmx.cpu()), w,
                               input_dim=vocab, output_dim=dim,
                               sparse_grad=True)
    got.backward(tmx.nd.array(head, ctx=tmx.cpu()))
    assert np.array_equal(got.asnumpy(), np.asarray(out))
    assert w.grad.stype == "row_sparse"
    assert _rel(w.grad.asnumpy(), want_grad) <= TOL


SHAPE_OPS = [
    ("SwapAxis", [(2, 3, 4)], dict(dim1=0, dim2=2)),
    ("swapaxes", [(2, 3, 4)], dict(dim1=1, dim2=2)),
    ("stack", [(2, 3), (2, 3), (2, 3)], dict(axis=1)),
    ("Concat", [(2, 3), (2, 5)], dict(dim=1)),
    ("concat", [(4, 3), (1, 3)], dict(dim=0)),
    ("_rnn_param_concat", [(2, 3), (4,), (3, 1)], dict(dim=0)),
    ("SliceChannel", [(2, 6, 3)], dict(num_outputs=3, axis=1)),
    ("split", [(4, 2, 3)], dict(num_outputs=4, axis=0,
                                squeeze_axis=True)),
]


@pytest.mark.parametrize("name,shapes,attrs", SHAPE_OPS,
                         ids=[c[0] for c in SHAPE_OPS])
def test_shape_op_matches_the_reference(name, shapes, attrs):
    rng = np.random.RandomState(0)
    inputs = [rng.normal(0, 1, s).astype(np.float32) for s in shapes]
    jop = jmx.ops.registry.get_op(name)

    def fn(*args):
        out = jop.fn(*args, **attrs)
        return out if isinstance(out, tuple) else (out,)

    want, vjp = jax.vjp(fn, *[jax.numpy.asarray(a) for a in inputs])
    heads = [rng.normal(0, 1, w.shape).astype(np.float32) for w in want]
    want_grad = vjp(tuple(jax.numpy.asarray(h) for h in heads))
    xs = [tmx.nd.array(a, ctx=tmx.cpu()) for a in inputs]
    for x in xs:
        x.attach_grad()
    with tmx.autograd.record():
        got = getattr(tmx.nd, name)(*xs, **attrs)
    got = got if isinstance(got, list) else [got]
    assert len(got) == len(want)
    tmx.autograd.backward(got, [tmx.nd.array(h, ctx=tmx.cpu())
                                for h in heads])
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.array_equal(g.asnumpy(),
                                                     np.asarray(w))
    for x, w in zip(xs, want_grad):
        assert np.array_equal(x.grad.asnumpy(), np.asarray(w))


def test_slice_channel_raises_on_an_uneven_split():
    with pytest.raises(MXNetError, match="does not split"):
        tmx.nd.SliceChannel(tmx.nd.zeros((2, 5), ctx=tmx.cpu()),
                            num_outputs=2, axis=1)


class _Spy(object):
    """Wraps a function; records both TF32 flags at each call."""

    def __init__(self, fn):
        self.fn, self.seen = fn, []

    def __call__(self, *args, **kwargs):
        self.seen.append((torch.backends.cudnn.allow_tf32,
                          torch.backends.cuda.matmul.allow_tf32))
        return self.fn(*args, **kwargs)


def _library_calls(route):
    """Convolution, FullyConnected and RNN on float32 through ``route``:
    raw ``nd``, an executor, or a CachedOp."""
    cpu = tmx.cpu()
    rng = np.random.RandomState(0)
    conv_in = [rng.normal(0, 1, s).astype(np.float32)
               for s in ((1, 2, 5, 5), (3, 2, 3, 3), (3,))]
    fc_in = [rng.normal(0, 1, s).astype(np.float32)
             for s in ((2, 4), (3, 4), (3,))]
    rnn_in = _case("lstm", False, 1)
    if route == "nd":
        nd = tmx.nd
        arr = [[nd.array(a, ctx=cpu) for a in xs]
               for xs in (conv_in, fc_in, rnn_in)]
        nd.Convolution(*arr[0], kernel=(3, 3), num_filter=3)
        nd.FullyConnected(*arr[1], num_hidden=3)
        nd.RNN(*arr[2], state_size=H, num_layers=1, mode="lstm")
        return
    sym = tmx.sym
    heads = [sym.Convolution(sym.var("a0"), sym.var("a1"), sym.var("a2"),
                             kernel=(3, 3), num_filter=3),
             sym.FullyConnected(sym.var("b0"), sym.var("b1"), sym.var("b2"),
                                num_hidden=3),
             sym.RNN(sym.var("c0"), sym.var("c1"), sym.var("c2"),
                     sym.var("c3"), state_size=H, num_layers=1,
                     mode="lstm")]
    group = sym.Group(heads)
    values = dict(zip(["a0", "a1", "a2", "b0", "b1", "b2", "c0", "c1", "c2",
                       "c3"], conv_in + fc_in + rnn_in))
    args = [tmx.nd.array(values[n], ctx=cpu)
            for n in group.list_arguments()]
    if route == "executor":
        group.bind(cpu, args=args).forward()
    else:
        tmx.cached_op.CachedOp(group)(args)


@pytest.mark.parametrize("route", ["nd", "executor", "cached_op"])
def test_library_ops_see_tf32_off(route, monkeypatch):
    spies = {"conv": _Spy(tnn._CONV[2]), "linear": _Spy(
        torch.nn.functional.linear), "rnn": _Spy(trnn.rnn_plain)}
    monkeypatch.setitem(tnn._CONV, 2, spies["conv"])
    monkeypatch.setattr(torch.nn.functional, "linear", spies["linear"])
    monkeypatch.setattr(trnn, "rnn_plain", spies["rnn"])
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        _library_calls(route)
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = saved
    for name, spy in spies.items():
        # binding an executor also runs the ops on meta tensors
        assert spy.seen and set(spy.seen) == {(False, False)}, \
            (name, spy.seen)
