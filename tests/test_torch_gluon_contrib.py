"""The PyTorch port's `gluon.contrib` (`mxtpu_torch/gluon/contrib/`)
against the JAX package's (`mxtpu/gluon/contrib/`).

* The recurrent cells: `LSTMPCell` and the nine convolutional cells
  (RNN, LSTM, GRU in 1-D, 2-D, 3-D; the 2-D ones in `_b`, the 3-D ones
  in `_c`) are built in both packages, given
  the same weights by name and unrolled in layouts NTC and TNC under
  `autograd.record()`: outputs, last states and the gradients of the
  inputs and the Parameters within a relative L2 of 1e-5
  (`test_torch_rnn_cell.py`'s harness).  `VariationalDropoutCell` is
  held so at p = 0, and at p > 0 by its rule: one mask a sequence,
  shared by every step, drawn anew by the next unroll.
* `SparseEmbedding`: the weight's gradient row-sparse, over the
  reference's in-range ids, equal to its densified gradient (1e-6), and
  one SGD step of a Trainer on it.
* The layers (`Concurrent`, `HybridConcurrent`, `Identity`,
  `SyncBatchNorm`, `PixelShuffle2D`) and a HybridBlock looping with
  `F.contrib.foreach` are rows of `test_torch_gluon.py`'s
  `CONTRIB_LAYERS`, run in `_d` by its `_parity` harness (relative L2 1e-5 of
  the output, the input and Parameter gradients and the Parameters,
  moving statistics included), hybridized and not.
"""
import numpy as np
import pytest

import mxtpu as jmx
import mxtpu_torch as tmx
from mxtpu_torch.gluon.parameter import load_numpy

from test_torch_gluon import _rel, _x
from test_torch_rnn_cell import T, _build, _unroll
import torch

torch.set_num_threads(1)

TOL = 1e-5
N = 2


def _conv(kind, dims):
    spatial = {1: (5,), 2: (4, 4), 3: (3, 3, 3)}[dims]
    name = "Conv%dD%sCell" % (dims, kind)
    return (lambda mx: getattr(mx.gluon.contrib.rnn, name)(
        (2,) + spatial, 3, 3, 3, i2h_pad=1), (2,) + spatial)


CELLS = {"lstmp": (lambda mx: mx.gluon.contrib.rnn.LSTMPCell(6, 3), (5,)),
         "vardrop_0": (lambda mx: mx.gluon.contrib.rnn.VariationalDropoutCell(
             mx.gluon.rnn.LSTMCell(4)), (5,))}
for _kind in ("RNN", "LSTM", "GRU"):
    for _dims in (1, 2, 3):
        CELLS["conv%dd_%s" % (_dims, _kind.lower())] = _conv(_kind, _dims)


def shard(k):
    """The cells of shard ``k`` (this file, ``_b`` and ``_c``): the 3-D
    and 2-D convolutional cells apart, to keep each file under 30 s."""
    groups = [[n for n in sorted(CELLS) if not n.startswith(("conv2d",
                                                              "conv3d"))],
              [n for n in sorted(CELLS) if n.startswith("conv2d")],
              [n for n in sorted(CELLS) if n.startswith("conv3d")]]
    assert sorted(sum(groups, [])) == sorted(CELLS)
    return groups[k]


def unroll_case(name, layout):
    make, step_shape = CELLS[name]
    x = _x(*(((N, T) if layout == "NTC" else (T, N)) + step_shape))
    jc = _build(jmx, make, x, layout)
    rng = np.random.RandomState(0)
    weights = {k: rng.normal(0, 0.5, p.shape).astype(np.float32)
               for k, p in jc.collect_params().items()}
    for k, p in jc.collect_params().items():
        p.set_data(jmx.nd.array(weights[k], ctx=jmx.cpu()))
    tc = _build(tmx, make, x, layout)
    assert sorted(tc.collect_params().keys()) == sorted(weights)
    load_numpy(tc.collect_params(), weights)
    j = _unroll(jmx, jc, x, layout, True, None)
    t = _unroll(tmx, tc, x, layout, True, None, heads=j[3])
    assert len(t[0]) == len(j[0])
    for a, b in zip(t[0], j[0]):
        assert a.shape == b.shape and _rel(a, b) <= TOL
    assert _rel(t[1], j[1]) <= TOL
    assert set(t[2]) == set(j[2])
    for k in j[2]:
        assert _rel(t[2][k], j[2][k]) <= TOL, k
    assert [i["shape"] for i in tc.state_info(N)] == \
        [i["shape"] for i in jc.state_info(N)]


@pytest.mark.parametrize("layout", ["NTC", "TNC"])
@pytest.mark.parametrize("name", shard(0))
def test_cell_unroll_matches_the_reference(name, layout):
    unroll_case(name, layout)


def test_variational_dropout_shares_one_mask_across_steps():
    """drop_outputs 0.5 over an RNN cell whose outputs are never 0: the
    zeros are the same at every step, about half of them (4 standard
    errors), scaled by 2 elsewhere; the next unroll draws another."""
    tmx.random.seed(4)
    base = tmx.gluon.rnn.RNNCell(400, activation="relu", input_size=3,
                                 i2h_weight_initializer="ones",
                                 h2h_weight_initializer="zeros",
                                 i2h_bias_initializer="ones")
    cell = tmx.gluon.contrib.rnn.VariationalDropoutCell(
        base, drop_inputs=0.0, drop_outputs=0.5)
    cell.initialize(ctx=tmx.cpu())
    x = tmx.nd.ones((T, N, 3), ctx=tmx.cpu())
    masks = []
    for _ in range(2):
        with tmx.autograd.train_mode():
            outs, _ = cell.unroll(T, x, layout="TNC", merge_outputs=True)
        kept = outs.asnumpy() != 0
        assert (kept == kept[0]).all()
        p = kept[0].mean()
        assert abs(p - 0.5) < 4 * np.sqrt(0.25 / kept[0].size), p
        np.testing.assert_allclose(outs.asnumpy()[kept], 8.0)
        masks.append(kept[0])
    assert not np.array_equal(masks[0], masks[1])
    outs, _ = cell.unroll(T, x, layout="TNC", merge_outputs=True)
    np.testing.assert_allclose(outs.asnumpy(), 4.0)  # not training


def _sparse_embedding(mx, weight, ids, lr=None):
    emb = mx.gluon.contrib.nn.SparseEmbedding(6, 4, prefix="semb_")
    emb.initialize(ctx=mx.cpu())
    emb.weight.set_data(mx.nd.array(weight, ctx=mx.cpu()))
    head = np.random.RandomState(7).randn(*(ids.shape + (4,))) \
        .astype(np.float32)
    with mx.autograd.record():
        out = emb(mx.nd.array(ids, ctx=mx.cpu()))
    out.backward(mx.nd.array(head, ctx=mx.cpu()))
    grad = emb.weight.grad()
    result = (out.asnumpy(), grad.stype,
              grad.tostype("default").asnumpy(), grad.indices.asnumpy())
    if lr is not None:
        trainer = mx.gluon.Trainer(emb.collect_params(), "sgd",
                                   {"learning_rate": lr})
        trainer.step(1)
        result += (emb.weight.data().asnumpy(),)
    return result


def test_sparse_embedding_matches_the_reference():
    weight = np.random.RandomState(2).randn(6, 4).astype(np.float32)
    ids = np.array([[0, 4, 4], [2, 9, -3]], np.float32)
    t = _sparse_embedding(tmx, weight, ids, lr=0.5)
    j = _sparse_embedding(jmx, weight, ids, lr=0.5)
    np.testing.assert_array_equal(t[0], j[0])
    assert t[1] == j[1] == "row_sparse"
    np.testing.assert_allclose(t[2], j[2], rtol=1e-6, atol=1e-6)
    assert set(t[3].tolist()) == {int(i) for i in j[3] if 0 <= i < 6} \
        == {0, 2, 4, 5}
    np.testing.assert_allclose(t[4], j[4], rtol=1e-6, atol=1e-6)
    assert repr(tmx.gluon.contrib.nn.SparseEmbedding(6, 4)) == \
        repr(jmx.gluon.contrib.nn.SparseEmbedding(6, 4))
