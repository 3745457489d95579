"""The PyTorch port's gluon recurrent path against the JAX package's, on
the CPU: the fused layers (``gluon.rnn.RNN``/``LSTM``/``GRU``), gluon's
``Embedding``, the word language model of
``examples/rnn/word_lm/train.py`` (Embedding -> LSTM -> a Dense decoder,
tied to the embedding or not) trained three SGD steps with clipping and
detached states, and ``metric.Perplexity``.

Both packages start from the same numpy weights (``load_numpy``); the
layers go through ``test_torch_gluon.py``'s ``_parity`` harness (its
``TOL``, a relative L2 of 1e-5).  The word LM's losses and weights are
held to a relative L2 of ``LM_TOL`` (1e-5) after each of three steps:
float32 sums in other orders, carried through three updates at lr 1.
"""
import math

import numpy as np
import pytest

import mxtpu as jmx
import mxtpu_torch as tmx
from mxtpu_torch.base import MXNetError
from mxtpu_torch.gluon.parameter import load_numpy

from test_torch_gluon import _parity, _rel, _x
import torch

torch.set_num_threads(1)

LM_TOL = 1e-5
VOCAB, WIDTH, LAYERS, BPTT, BATCH = 50, 16, 2, 5, 4

RNN_LAYERS = {
    "lstm": lambda mx: mx.gluon.rnn.LSTM(6, num_layers=2),
    "lstm_ntc_bidirectional": lambda mx: mx.gluon.rnn.LSTM(
        5, layout="NTC", bidirectional=True),
    "gru": lambda mx: mx.gluon.rnn.GRU(6, num_layers=2),
    "gru_ntc_bidirectional": lambda mx: mx.gluon.rnn.GRU(
        4, layout="NTC", bidirectional=True),
    "rnn_relu": lambda mx: mx.gluon.rnn.RNN(6, num_layers=2),
    "rnn_tanh_ntc": lambda mx: mx.gluon.rnn.RNN(
        6, activation="tanh", layout="NTC"),
}


@pytest.mark.parametrize("hybridize", [False, True])
@pytest.mark.parametrize("name", sorted(RNN_LAYERS))
def test_rnn_layer_matches_the_reference(name, hybridize):
    """Called on data alone (zero begin states, the outputs returned),
    the first layer's input width deferred to the call unless given."""
    shape = (2, 4, 3) if "ntc" in name else (4, 2, 3)
    _parity(RNN_LAYERS[name], [_x(*shape)], hybridize=hybridize,
            key=("rnn", name))


def _states_case(mx, hybridize):
    with mx.sym.NameManager():
        layer = mx.gluon.rnn.LSTM(5, num_layers=2, layout="NTC")
    layer.initialize(ctx=mx.cpu())
    if hybridize:
        layer.hybridize()
    return layer


@pytest.mark.parametrize("hybridize", [False, True])
def test_rnn_layer_with_states_matches_the_reference(hybridize):
    x = _x(3, 4, 2)
    states = [_x(2, 3, 5, seed=2), _x(2, 3, 5, seed=3)]
    jl, tl = _states_case(jmx, True), _states_case(tmx, hybridize)
    jl(jmx.nd.array(x, ctx=jmx.cpu()))  # infers the input width
    rng = np.random.RandomState(0)
    arrays = {k: rng.normal(0, 0.5, p.shape).astype(np.float32)
              for k, p in jl.collect_params().items()}
    for k, p in jl.collect_params().items():
        p.set_data(jmx.nd.array(arrays[k], ctx=jmx.cpu()))
    tl(tmx.nd.array(x, ctx=tmx.cpu()))
    load_numpy(tl.collect_params(), arrays)
    jout, jst = jl(jmx.nd.array(x, ctx=jmx.cpu()),
                   [jmx.nd.array(s, ctx=jmx.cpu()) for s in states])
    tout, tst = tl(tmx.nd.array(x, ctx=tmx.cpu()),
                   [tmx.nd.array(s, ctx=tmx.cpu()) for s in states])
    assert _rel(tout.asnumpy(), jout.asnumpy()) <= LM_TOL
    assert len(tst) == len(jst) == 2
    for a, b in zip(tst, jst):
        assert _rel(a.asnumpy(), b.asnumpy()) <= LM_TOL


def test_begin_state_shapes_and_device():
    for layer, n in ((tmx.gluon.rnn.LSTM(7, num_layers=3), 2),
                     (tmx.gluon.rnn.GRU(7, bidirectional=True), 1),
                     (tmx.gluon.rnn.RNN(7, num_layers=2,
                                        bidirectional=True), 1)):
        states = layer.begin_state(4, ctx=tmx.cpu())
        d = 2 if "r0_i2h_weight" in "".join(layer.collect_params()) else 1
        assert len(states) == n
        for s in states:
            assert s.shape == (layer._num_layers * d, 4, 7)
            assert s.ctx == tmx.cpu() and not s.asnumpy().any()
    with pytest.raises(MXNetError, match="layout"):
        tmx.gluon.rnn.LSTM(4, layout="CTN")


def test_rnn_layer_parameter_names_match_the_reference():
    for make in RNN_LAYERS.values():
        with jmx.sym.NameManager():
            jn = list(make(jmx).collect_params())
        with tmx.sym.NameManager():
            tn = list(make(tmx).collect_params())
        assert tn == jn


@pytest.mark.parametrize("hybridize", [False, True])
def test_embedding_layer_matches_the_reference(hybridize):
    ids = np.array([[0, 3, 9], [11, -2, 5]], np.float32)  # 11, -2 clip
    _parity(lambda mx: mx.gluon.nn.Embedding(10, 4), [ids],
            hybridize=hybridize, key="embedding")


def test_embedding_layer_sparse_grad_raises():
    """A row-sparse gradient cannot accumulate (grad_req="add"), as in
    the reference; a row-sparse weight (stype) is stored and kept dense,
    as in `mxtpu` (test_torch_gluon_stype.py trains one)."""
    layer = tmx.gluon.nn.Embedding(10, 4, sparse_grad=True)
    layer.initialize(ctx=tmx.cpu())
    layer.weight.grad_req = "add"
    layer.weight._init_grad()
    with tmx.autograd.record():
        loss = layer(tmx.nd.array([[1.0, 2.0]], ctx=tmx.cpu())).sum()
    with pytest.raises(MXNetError, match="grad_req='add'"):
        loss.backward()
    for M in (jmx, tmx):
        w = M.gluon.Parameter("w", shape=(10, 4), stype="row_sparse")
        w.initialize(ctx=M.cpu())
        assert w._stype == "row_sparse" and w.data().stype == "default"


def _word_lm(mx, tied, dropout=0.0):
    """examples/rnn/word_lm/train.py's RNNModel, the LSTM's input width
    given (a hybridized parent cannot infer it in either package)."""

    class RNNModel(mx.gluon.nn.HybridBlock):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.drop = mx.gluon.nn.Dropout(dropout)
                self.encoder = mx.gluon.nn.Embedding(VOCAB, WIDTH)
                self.rnn = mx.gluon.rnn.LSTM(WIDTH, num_layers=LAYERS,
                                             dropout=dropout,
                                             input_size=WIDTH)
                if tied:
                    self.decoder = mx.gluon.nn.Dense(
                        VOCAB, flatten=False, params=self.encoder.params)
                else:
                    self.decoder = mx.gluon.nn.Dense(VOCAB, flatten=False,
                                                     in_units=WIDTH)

        def hybrid_forward(self, F, x, states):
            emb = self.drop(self.encoder(x))
            out, states = self.rnn(emb, states)
            return self.decoder(self.drop(out)), states

    with mx.sym.NameManager():
        net = RNNModel()
    net.initialize(ctx=mx.cpu())
    return net


def _markov_stream(n, vocab, seed=3):
    """The example's synthetic corpus: the next token (7 t + 3) mod
    vocab with probability 0.85, else uniform."""
    rng = np.random.RandomState(seed)
    toks = [rng.randint(1, vocab)]
    for _ in range(n - 1):
        toks.append((toks[-1] * 7 + 3) % vocab if rng.rand() < 0.85
                    else rng.randint(0, vocab))
    return np.array(toks, np.float32)


def _train_lm(mx, net, weights, steps=3):
    """``steps`` steps of the example's recipe (SGD lr 1 here, clip
    0.25, the mean loss, states detached at each boundary): the losses
    and the weights after each step."""
    if mx is tmx:
        load_numpy(net.collect_params(), weights)
    else:
        for k, p in net.collect_params().items():
            p.set_data(mx.nd.array(weights[k], ctx=mx.cpu()))
    data = _markov_stream(BPTT * BATCH * steps + 1, VOCAB)
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 1.0})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    states = [mx.nd.zeros((LAYERS, BATCH, WIDTH), ctx=mx.cpu())
              for _ in range(2)]
    params = [p for p in net.collect_params().values()
              if p.grad_req != "null"]
    losses, snapshots = [], []
    for i in range(steps):
        chunk = data[i * BPTT * BATCH:(i + 1) * BPTT * BATCH + 1]
        x = mx.nd.array(chunk[:-1].reshape(BPTT, BATCH), ctx=mx.cpu())
        y = mx.nd.array(chunk[1:].reshape(BPTT, BATCH), ctx=mx.cpu())
        states = [s.detach() for s in states]
        with mx.autograd.record():
            logits, states = net(x, states)
            loss = loss_fn(logits, y).mean()
        loss.backward()
        mx.gluon.utils.clip_global_norm([p.grad() for p in params], 0.25)
        trainer.step(1)
        losses.append(float(loss.asnumpy()))
        snapshots.append({k: p.data().asnumpy()
                          for k, p in net.collect_params().items()})
    return losses, snapshots


_LM_REFERENCE = {}


@pytest.mark.parametrize("hybridize", [False, True])
@pytest.mark.parametrize("tied", [True, False])
def test_word_lm_trains_as_the_reference(tied, hybridize):
    if tied not in _LM_REFERENCE:
        net = _word_lm(jmx, tied)
        net.hybridize()
        rng = np.random.RandomState(0)
        with jmx.autograd.pause():
            net(jmx.nd.zeros((BPTT, BATCH), ctx=jmx.cpu()),
                [jmx.nd.zeros((LAYERS, BATCH, WIDTH), ctx=jmx.cpu())] * 2)
        weights = {k: rng.uniform(-0.1, 0.1, p.shape).astype(np.float32)
                   for k, p in net.collect_params().items()}
        _LM_REFERENCE[tied] = (weights, _train_lm(jmx, net, weights))
    weights, (want_losses, want) = _LM_REFERENCE[tied]
    net = _word_lm(tmx, tied)
    params = net.collect_params()
    # tied: one Parameter, embedding0_weight, serves both uses
    names = [k for k in params if k.endswith("_weight")
             and "lstm" not in k]
    assert len(names) == (1 if tied else 2), names
    assert sorted(params) == sorted(weights)
    if hybridize:
        net.hybridize()
    losses, got = _train_lm(tmx, net, weights)
    assert _rel(losses, want_losses) <= LM_TOL, (losses, want_losses)
    for step, (g, w) in enumerate(zip(got, want)):
        for k in w:
            assert _rel(g[k], w[k]) <= LM_TOL, (step, k, _rel(g[k], w[k]))


def test_word_lm_states_carry_no_graph_across_steps():
    """A state kept from one step and detached holds no autograd
    history, and a second step's backward needs nothing of the first
    step's graph."""
    net = _word_lm(tmx, True)
    net.hybridize()
    x = tmx.nd.array(_markov_stream(BPTT * BATCH, VOCAB).reshape(
        BPTT, BATCH), ctx=tmx.cpu())
    states = [tmx.nd.zeros((LAYERS, BATCH, WIDTH), ctx=tmx.cpu())] * 2
    for _ in range(2):
        states = [s.detach() for s in states]
        assert all(s._data.grad_fn is None and not s._data.requires_grad
                   for s in states)
        with tmx.autograd.record():
            logits, states = net(x, states)
            loss = logits.mean()
        loss.backward()
        assert states[0]._data.grad_fn is not None


@pytest.mark.parametrize("ignore_label", [None, 0])
def test_perplexity_matches_the_reference(ignore_label):
    rng = np.random.RandomState(0)
    jm = jmx.metric.Perplexity(ignore_label=ignore_label)
    tm = tmx.metric.create("perplexity", ignore_label=ignore_label)
    for n in (12, 7):
        logits = rng.normal(0, 2, (n, 9))
        pred = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True))
        pred = pred.astype(np.float32)
        label = rng.randint(0, 9, (n,)).astype(np.float32)
        label[::3] = 0  # ignored when ignore_label is 0
        jm.update([jmx.nd.array(label, ctx=jmx.cpu())],
                  [jmx.nd.array(pred, ctx=jmx.cpu())])
        tm.update([tmx.nd.array(label, ctx=tmx.cpu())],
                  tmx.nd.array(pred, ctx=tmx.cpu()))
    assert tm.get()[0] == jm.get()[0] == "perplexity"
    assert tm.num_inst == jm.num_inst == (19 if ignore_label is None
                                          else 12)
    assert math.isclose(tm.get()[1], jm.get()[1], rel_tol=1e-6)
    tm.reset()
    assert math.isnan(tm.get()[1])
