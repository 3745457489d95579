"""The PyTorch port's gluon losses (`mxtpu_torch/gluon/loss.py`) and
the ops this slice added against the JAX package's, forward and
gradient, with `test_torch_gluon.py`'s harness: the same numpy inputs,
parameters and head gradient in both packages; the loss's gradients
with respect to the prediction and the label, imperative and
hybridized, within a relative L2 of 1e-5 (float32 arithmetic summed in
other orders).  The ops run through `nd` under `autograd.record()`.
"""
import json

import numpy as np
import pytest

import mxtpu as jmx
import mxtpu_torch as tmx
from mxtpu_torch.base import MXNetError
from test_torch_gluon import TOL, _build, _parity, _rel, _x
import torch

torch.set_num_threads(1)


def _label(n, classes, seed=3):
    return np.random.RandomState(seed).randint(0, classes, (n,)).astype(
        np.float32)


def _probs(*shape, seed=4):
    return np.random.RandomState(seed).uniform(0.05, 0.95, shape).astype(
        np.float32)


# CTC labels padded with -1 (the blank is class 0)
CTC_LABEL = np.array([[1, 2, 2, -1], [3, -1, -1, -1], [4, 1, 3, 2]],
                     np.float32)

LOSSES = {
    "l2": (lambda mx: mx.gluon.loss.L2Loss(), [_x(4, 3), _x(4, 3, seed=2)],
           ()),
    "l2_weighted_sample_weight": (
        lambda mx: mx.gluon.loss.L2Loss(weight=0.3),
        [_x(4, 3), _x(4, 3, seed=2)], (_probs(4, 1),)),
    "l1": (lambda mx: mx.gluon.loss.L1Loss(), [_x(4, 3), _x(4, 3, seed=2)],
           ()),
    "l1_batch_axis": (lambda mx: mx.gluon.loss.L1Loss(batch_axis=1),
                      [_x(3, 5), _x(3, 5, seed=2)], ()),
    "sigmoid_bce": (lambda mx: mx.gluon.loss.SigmoidBinaryCrossEntropyLoss(),
                    [_x(4, 3), _probs(4, 3).round()], ()),
    "sigmoid_bce_pos_weight": (
        lambda mx: mx.gluon.loss.SigmoidBCELoss(weight=2.0),
        [_x(4, 3), _probs(4, 3).round()], (None, _probs(4, 3) * 3)),
    "sigmoid_bce_from_sigmoid": (
        lambda mx: mx.gluon.loss.SigmoidBCELoss(from_sigmoid=True),
        [_probs(4, 3), _probs(4, 3, seed=5).round()], ()),
    "sigmoid_bce_from_sigmoid_pos_weight": (
        lambda mx: mx.gluon.loss.SigmoidBCELoss(from_sigmoid=True),
        [_probs(4, 3), _probs(4, 3, seed=5).round()],
        (_probs(4, 1), _probs(4, 3) * 2)),
    "softmax_ce": (lambda mx: mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                   [_x(5, 7), _label(5, 7)], ()),
    "softmax_ce_sample_weight": (
        lambda mx: mx.gluon.loss.SoftmaxCELoss(weight=0.5),
        [_x(5, 7), _label(5, 7)], (_probs(5, 1),)),
    "softmax_ce_label_out_of_range": (
        lambda mx: mx.gluon.loss.SoftmaxCELoss(),
        [_x(5, 7), np.array([-2, 0, 6, 9, 3.7], np.float32)], ()),
    "softmax_ce_dense": (
        lambda mx: mx.gluon.loss.SoftmaxCELoss(sparse_label=False),
        [_x(5, 7), _probs(5, 7)], ()),
    "softmax_ce_from_logits_axis": (
        lambda mx: mx.gluon.loss.SoftmaxCELoss(axis=1, from_logits=True),
        [_x(2, 6, 3), _label(2 * 3, 6).reshape(2, 3)], ()),
    "kl_div": (lambda mx: mx.gluon.loss.KLDivLoss(),
               [_x(4, 6), _probs(4, 6)], ()),
    "kl_div_logits": (lambda mx: mx.gluon.loss.KLDivLoss(from_logits=False),
                      [_x(4, 6), _probs(4, 6)], ()),
    "huber": (lambda mx: mx.gluon.loss.HuberLoss(rho=0.7),
              [_x(4, 3), _x(4, 3, seed=2)], ()),
    "hinge": (lambda mx: mx.gluon.loss.HingeLoss(margin=0.5),
              [_x(4, 3), np.sign(_x(4, 3, seed=2))], ()),
    "squared_hinge": (lambda mx: mx.gluon.loss.SquaredHingeLoss(),
                      [_x(4, 3), np.sign(_x(4, 3, seed=2))], ()),
    "logistic_signed": (lambda mx: mx.gluon.loss.LogisticLoss(),
                        [_x(4, 3), np.sign(_x(4, 3, seed=2))], ()),
    "logistic_binary": (
        lambda mx: mx.gluon.loss.LogisticLoss(label_format="binary"),
        [_x(4, 3), _probs(4, 3).round()], ()),
    # on CTCLoss, and the losses of a sample's three inputs
    "ctc": (lambda mx: mx.gluon.loss.CTCLoss(),
            [_x(3, 8, 5), CTC_LABEL], ()),
    "ctc_tnc_lengths": (
        lambda mx: mx.gluon.loss.CTCLoss(layout="TNC", label_layout="TN",
                                         weight=0.5),
        [_x(8, 3, 5), CTC_LABEL.T.copy()],
        (np.array([8, 6, 7], np.float32), np.array([2, 1, 3], np.float32))),
    "triplet": (lambda mx: mx.gluon.loss.TripletLoss(margin=0.5),
                [_x(4, 3), _x(4, 3, seed=2), _x(4, 3, seed=3)], ()),
    "poisson_nll": (lambda mx: mx.gluon.loss.PoissonNLLLoss(),
                    [_x(4, 3), _probs(4, 3) * 3], ()),
    "poisson_nll_full": (
        lambda mx: mx.gluon.loss.PoissonNLLLoss(from_logits=False,
                                                compute_full=True),
        [_probs(4, 3) + 0.1, _probs(4, 3, seed=5) * 4], ()),
    "cosine_embedding": (
        lambda mx: mx.gluon.loss.CosineEmbeddingLoss(margin=0.2),
        [_x(4, 5), _x(4, 5, seed=2), np.array([1, -1, 1, -1], np.float32)],
        ()),
}


@pytest.mark.parametrize("hybridize", [False, True])
@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_matches_the_reference(name, hybridize):
    """The loss and its gradient with respect to the prediction (and
    the label)."""
    make, inputs, extra = LOSSES[name]
    _parity(make, inputs, extra=extra, hybridize=hybridize,
            key=("loss", name))


def test_logistic_loss_rejects_an_unknown_label_format():
    with pytest.raises(MXNetError):
        tmx.gluon.loss.LogisticLoss(label_format="other")


# ---------------------------------------------------------------------------
# the ops this slice added, through nd, against the JAX package's
# ---------------------------------------------------------------------------

OPS = {
    "log_softmax": (lambda nd, x: nd.log_softmax(x, axis=1), [(3, 5, 2)]),
    "softmax_temperature": (lambda nd, x: nd.softmax(x, temperature=2.0),
                            [(3, 5)]),
    "relu": (lambda nd, x: nd.relu(x), [(3, 5)]),
    "abs": (lambda nd, x: nd.abs(x), [(3, 5)]),
    "square": (lambda nd, x: nd.square(x), [(3, 5)]),
    "exp": (lambda nd, x: nd.exp(x), [(3, 5)]),
    "log": (lambda nd, x: nd.log(nd.abs(x) + 0.5), [(3, 5)]),
    "softrelu": (lambda nd, x: nd.Activation(x, act_type="softrelu"),
                 [(3, 5)]),
    "reshape_like": (lambda nd, x, y: nd.reshape_like(x, y) * y,
                     [(3, 4), (2, 6)]),
    "where": (lambda nd, x, y: nd.where(x > 0.1, x, y), [(3, 4), (3, 4)]),
    "greater_scalar": (lambda nd, x: (x > 0.2) * x, [(3, 4)]),
}


@pytest.mark.parametrize("name", sorted(OPS))
def test_op_matches_the_reference(name):
    fn, shapes = OPS[name]
    xs = [_x(*s, seed=i + 1) for i, s in enumerate(shapes)]
    res = []
    for mx in (jmx, tmx):
        arrs = [mx.nd.array(x, ctx=mx.cpu()) for x in xs]
        for a in arrs:
            a.attach_grad()
        with mx.autograd.record():
            out = fn(mx.nd, *arrs)
        head = np.random.RandomState(9).normal(0, 1, out.shape)
        out.backward(mx.nd.array(head.astype(np.float32), ctx=mx.cpu()))
        res.append((out.asnumpy(), [a.grad.asnumpy() for a in arrs]))
    (jo, jg), (to, tg) = res
    assert _rel(to, jo) <= TOL
    for a, b in zip(tg, jg):
        assert _rel(a, b) <= TOL


@pytest.mark.parametrize("mode", ["clip", "wrap"])
@pytest.mark.parametrize("keepdims", [False, True])
@pytest.mark.parametrize("axis", [-1, 0])
def test_pick_with_float_labels_matches_the_reference(mode, keepdims, axis):
    """Labels arrive as float32 (truncated to integers) and may lie
    outside the axis (clipped or wrapped)."""
    x = _x(4, 5)
    n = x.shape[1 - axis % 2]
    index = np.array([0, 2.7, -3, 7, 4.2][:n], np.float32)
    res = []
    for mx in (jmx, tmx):
        a = mx.nd.array(x, ctx=mx.cpu())
        a.attach_grad()
        with mx.autograd.record():
            out = mx.nd.pick(a, mx.nd.array(index, ctx=mx.cpu()), axis=axis,
                             keepdims=keepdims, mode=mode)
        out.backward(mx.nd.array(np.arange(out.size, dtype=np.float32)
                                 .reshape(out.shape), ctx=mx.cpu()))
        res.append((out.asnumpy(), a.grad.asnumpy()))
    np.testing.assert_array_equal(res[1][0], res[0][0])
    np.testing.assert_array_equal(res[1][1], res[0][1])


def test_symbol_arithmetic_matches_the_reference():
    def build(mx):
        a, b = mx.sym.var("a"), mx.sym.var("b")
        return mx.sym.Group([a + b, a - 2.0, 3.0 - b, a * b, 2 * a, a / b,
                             1.0 / b, -a, a > 0.5])

    j, t = _build(jmx, build), _build(tmx, build)
    assert t.list_outputs() == j.list_outputs()
    assert json.loads(t.tojson()) == json.loads(j.tojson())
