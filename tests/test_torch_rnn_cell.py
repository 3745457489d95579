"""The PyTorch port's recurrent cells (`mxtpu_torch/gluon/rnn/
rnn_cell.py`) against the JAX package's (`mxtpu/gluon/rnn/rnn_cell.py`)
on the CPU.

Each cell is built in both packages inside a fresh `NameManager`, its
deferred Parameters sized by a first unroll, given the same numpy
weights (`load_numpy`, by name) and unrolled on the same inputs under
`autograd.record()`: layouts NTC and TNC, `merge_outputs` on and off,
the begin states given or made by `unroll`.  The outputs, the last
states, the inputs' and the Parameters' gradients of the same random
heads must agree within a relative L2 of `TOL` (1e-5: float32 sums in
other orders over a few steps).  Dropout and Zoneout are held so at
p = 0, and by the rates of their masks (within 4 standard errors) at
p > 0, since their draws come from another generator.  An unrolled
LSTMCell equals the fused `gluon.rnn.LSTM` on the same weights, and a
BidirectionalCell cannot be stepped.
"""
import numpy as np
import pytest

import mxtpu as jmx
import mxtpu_torch as tmx
from mxtpu_torch.base import MXNetError
from mxtpu_torch.gluon.parameter import load_numpy

from test_torch_gluon import _rel, _x
import torch

torch.set_num_threads(1)

TOL = 1e-5
T, N, C = 4, 3, 5


def _lstm_gru(mx):
    cell = mx.gluon.rnn.SequentialRNNCell()
    with cell.name_scope():
        cell.add(mx.gluon.rnn.LSTMCell(6))
        cell.add(mx.gluon.rnn.DropoutCell(0.0))
        cell.add(mx.gluon.rnn.GRUCell(4))
    return cell


CELLS = {
    "rnn_tanh": lambda mx: mx.gluon.rnn.RNNCell(6),
    "rnn_relu": lambda mx: mx.gluon.rnn.RNNCell(6, activation="relu",
                                                input_size=C),
    "lstm": lambda mx: mx.gluon.rnn.LSTMCell(6),
    "gru": lambda mx: mx.gluon.rnn.GRUCell(6),
    "sequential_dropout_0": _lstm_gru,
    "residual": lambda mx: mx.gluon.rnn.ResidualCell(
        mx.gluon.rnn.GRUCell(C)),
    "zoneout_0": lambda mx: mx.gluon.rnn.ZoneoutCell(
        mx.gluon.rnn.LSTMCell(6)),
    "bidirectional": lambda mx: mx.gluon.rnn.BidirectionalCell(
        mx.gluon.rnn.LSTMCell(4, prefix="l_"),
        mx.gluon.rnn.GRUCell(3, prefix="r_")),
}


def _unroll(mx, cell, x, layout, merge, states, heads=None):
    """(outputs, last states, input gradient, {param: grad}) of one
    recorded unroll and backward with ``heads`` (drawn when None)."""
    xa = mx.nd.array(x, ctx=mx.cpu())
    xa.attach_grad()
    begin = None if states is None else [mx.nd.array(s, ctx=mx.cpu())
                                         for s in states]
    with mx.autograd.record():
        outs, last = cell.unroll(T, xa, begin_state=begin, layout=layout,
                                 merge_outputs=merge)
        flat = (outs if isinstance(outs, list) else [outs]) + list(last)
    if heads is None:
        heads = [np.random.RandomState(7 + k).normal(0, 1, o.shape).astype(
            np.float32) for k, o in enumerate(flat)]
    mx.autograd.backward(flat, [mx.nd.array(h, ctx=mx.cpu()) for h in heads])
    grads = {k: p.grad().asnumpy() for k, p in cell.collect_params().items()
             if p.grad_req != "null"}
    return [o.asnumpy() for o in flat], xa.grad.asnumpy(), grads, heads


def _build(mx, make, x, layout):
    with mx.sym.NameManager():
        cell = make(mx)
    cell.initialize(ctx=mx.cpu())
    cell.unroll(T, mx.nd.array(x, ctx=mx.cpu()), layout=layout)
    return cell


def unroll_case(name, layout, merge, states):
    """One cell's unroll in both packages from the same weights and
    inputs."""
    x = _x(*((N, T, C) if layout == "NTC" else (T, N, C)))
    jc = _build(jmx, CELLS[name], x, layout)
    rng = np.random.RandomState(0)
    weights = {k: rng.normal(0, 0.5, p.shape).astype(np.float32)
               for k, p in jc.collect_params().items()}
    for k, p in jc.collect_params().items():
        p.set_data(jmx.nd.array(weights[k], ctx=jmx.cpu()))
    tc = _build(tmx, CELLS[name], x, layout)
    assert sorted(tc.collect_params().keys()) == sorted(weights)
    load_numpy(tc.collect_params(), weights)
    begin = [rng.normal(0, 1, i["shape"]).astype(np.float32)
             for i in jc.state_info(N)] if states else None
    j = _unroll(jmx, jc, x, layout, merge, begin)
    t = _unroll(tmx, tc, x, layout, merge, begin, heads=j[3])
    assert len(t[0]) == len(j[0])
    for a, b in zip(t[0], j[0]):
        assert a.shape == b.shape and _rel(a, b) <= TOL
    assert _rel(t[1], j[1]) <= TOL
    assert set(t[2]) == set(j[2])
    for k in j[2]:
        assert _rel(t[2][k], j[2][k]) <= TOL, k


SHARDS = (("rnn_tanh", "rnn_relu", "gru"), ("bidirectional", "lstm"),
          ("residual", "sequential_dropout_0", "zoneout_0"))


def shard(k):
    """The cells of shard ``k`` (this file, ``_b`` and ``_c``), grouped
    by the ops the JAX package compiles once a process."""
    assert sorted(sum(SHARDS, ())) == sorted(CELLS)
    return list(SHARDS[k])


@pytest.mark.parametrize("states", [False, True])
@pytest.mark.parametrize("merge", [False, True])
@pytest.mark.parametrize("layout", ["NTC", "TNC"])
@pytest.mark.parametrize("name", shard(0))
def test_unroll_matches_the_reference(name, layout, merge, states):
    unroll_case(name, layout, merge, states)


def test_a_hybridized_cell_steps_as_the_imperative_one():
    x = _x(T, N, C)
    res = []
    for hybridize in (False, True):
        cell = _build(tmx, CELLS["lstm"], x, "TNC")
        load_numpy(cell.collect_params(), {
            k: np.random.RandomState(1).normal(0, 0.5, p.shape).astype(
                np.float32) for k, p in cell.collect_params().items()})
        if hybridize:
            cell.hybridize()
        res.append(_unroll(tmx, cell, x, "TNC", True, None))
    for a, b in zip(res[0][0], res[1][0]):
        assert _rel(a, b) <= TOL
    assert _rel(res[0][1], res[1][1]) <= TOL


def test_state_info_and_begin_state():
    cell = tmx.gluon.rnn.SequentialRNNCell()
    cell.add(tmx.gluon.rnn.LSTMCell(6))
    cell.add(tmx.gluon.rnn.GRUCell(4))
    assert [i["shape"] for i in cell.state_info(3)] == [(3, 6), (3, 6),
                                                        (3, 4)]
    states = cell.begin_state(3, ctx=tmx.cpu())
    assert [s.shape for s in states] == [(3, 6), (3, 6), (3, 4)]
    assert all(float(s.asnumpy().sum()) == 0 for s in states)
    with pytest.raises(MXNetError):
        tmx.gluon.rnn.BidirectionalCell(tmx.gluon.rnn.LSTMCell(2),
                                        tmx.gluon.rnn.LSTMCell(2))(
            tmx.nd.zeros((1, 2), ctx=tmx.cpu()), [])


def test_the_lstm_cell_unrolled_is_the_fused_layer():
    """Gates in the fused layer's order (i, f, c, o): the layer's
    ``l0_*`` weights as the cell's."""
    x = _x(T, N, C)
    layer = tmx.gluon.rnn.LSTM(6, input_size=C)
    layer.initialize(ctx=tmx.cpu())
    rng = np.random.RandomState(2)
    weights = {k: rng.normal(0, 0.5, p.shape).astype(np.float32)
               for k, p in layer.collect_params().items()}
    load_numpy(layer.collect_params(), weights)
    cell = tmx.gluon.rnn.LSTMCell(6, input_size=C)
    cell.initialize(ctx=tmx.cpu())
    load_numpy(cell.collect_params(), {
        cell.prefix + k.split("l0_")[1]: v for k, v in weights.items()})
    want = layer(tmx.nd.array(x, ctx=tmx.cpu())).asnumpy()
    got, _ = cell.unroll(T, tmx.nd.array(x, ctx=tmx.cpu()), layout="TNC",
                         merge_outputs=True)
    assert _rel(got.asnumpy(), want) <= TOL


def _rate(kept, p):
    return abs(kept.mean() - (1 - p)) < 4 * np.sqrt(p * (1 - p) / kept.size)


def test_dropout_and_zoneout_masks_have_their_rates():
    tmx.random.seed(3)
    x = tmx.nd.ones((T, 200, 50), ctx=tmx.cpu())
    drop = tmx.gluon.rnn.DropoutCell(0.3)
    with tmx.autograd.train_mode():
        outs, states = drop.unroll(T, x, layout="TNC", merge_outputs=True)
    kept = outs.asnumpy() != 0
    assert states == [] and _rate(kept, 0.3)
    assert set(np.unique(outs.asnumpy())) <= {0.0, np.float32(1 / 0.7)}
    base = tmx.gluon.rnn.RNNCell(50, activation="relu", input_size=50,
                                 i2h_weight_initializer="ones",
                                 h2h_weight_initializer="zeros")
    zone = tmx.gluon.rnn.ZoneoutCell(base, zoneout_outputs=0.4,
                                     zoneout_states=0.2)
    zone.initialize(ctx=tmx.cpu())
    with tmx.autograd.train_mode():
        outs, _ = zone.unroll(1, x[:1], layout="TNC", merge_outputs=True)
    # the first step's kept outputs are the base's (50), the rest its
    # previous output (zeros)
    first = outs.asnumpy()[0]
    assert set(np.unique(first)) <= {0.0, 50.0}
    assert _rate(first != 0, 0.4)
