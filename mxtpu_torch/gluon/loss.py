"""Losses of the PyTorch port (counterpart of ``mxtpu/gluon/loss.py``),
with the reference's classes and semantics: ``sample_weight``, the
class ``weight``, and the mean over every axis but ``batch_axis``
(CTCLoss, TripletLoss and CosineEmbeddingLoss give one value a sample,
PoissonNLLLoss the mean of all).
"""
from __future__ import annotations

import numpy as np

from ..base import MXNetError
from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "CTCLoss", "HuberLoss", "HingeLoss",
           "SquaredHingeLoss", "LogisticLoss", "TripletLoss",
           "PoissonNLLLoss", "CosineEmbeddingLoss"]


def _apply_weighting(F, loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = F.broadcast_mul(loss, sample_weight)
    if weight is not None:
        loss = loss * weight
    return loss


class Loss(HybridBlock):
    def __init__(self, weight, batch_axis, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis

    def __repr__(self):
        return "%s(batch_axis=%s, w=%s)" % (self.__class__.__name__,
                                            self._batch_axis, self._weight)

    def _batch_mean(self, F, loss, sample_weight, weight=None):
        loss = _apply_weighting(F, loss, weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


class L2Loss(Loss):
    """``weight / 2 * (label - pred)^2``."""

    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        loss = F.square(F.reshape_like(label, pred) - pred)
        return self._batch_mean(F, loss, sample_weight, self._weight / 2)


class L1Loss(Loss):
    """``|label - pred|``."""

    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        loss = F.abs(F.reshape_like(label, pred) - pred)
        return self._batch_mean(F, loss, sample_weight, self._weight)


def _softrelu_of_minus_abs(F, pred):
    return F.Activation(-F.abs(pred), act_type="softrelu")


class SigmoidBinaryCrossEntropyLoss(Loss):
    """Binary cross-entropy of ``sigmoid(pred)`` (or of ``pred`` with
    ``from_sigmoid``), in the stable form for logits."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def hybrid_forward(self, F, pred, label, sample_weight=None,
                       pos_weight=None):
        label = F.reshape_like(label, pred)
        if not self._from_sigmoid:
            if pos_weight is None:
                loss = F.relu(pred) - pred * label + \
                    _softrelu_of_minus_abs(F, pred)
            else:
                log_weight = 1 + F.broadcast_mul(pos_weight - 1, label)
                loss = pred - pred * label + log_weight * (
                    _softrelu_of_minus_abs(F, pred) + F.relu(-pred))
        else:
            eps = 1e-12
            if pos_weight is None:
                loss = -(F.log(pred + eps) * label
                         + F.log(1. - pred + eps) * (1. - label))
            else:
                loss = -(F.broadcast_mul(F.log(pred + eps) * label,
                                         pos_weight)
                         + F.log(1. - pred + eps) * (1. - label))
        return self._batch_mean(F, loss, sample_weight, self._weight)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class SoftmaxCrossEntropyLoss(Loss):
    """``-log softmax(pred)[label]`` (``sparse_label``), or against a
    distribution ``label``; ``from_logits`` takes ``pred`` as
    log-probabilities already."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, axis=self._axis)
        if self._sparse_label:
            loss = -F.pick(pred, label, axis=self._axis, keepdims=True)
        else:
            loss = -F.sum(pred * F.reshape_like(label, pred),
                          axis=self._axis, keepdims=True)
        return self._batch_mean(F, loss, sample_weight, self._weight)


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class KLDivLoss(Loss):
    """``label * (log label - pred)``, ``pred`` as log-probabilities
    (``from_logits``) or logits."""

    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._axis = axis

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, axis=self._axis)
        loss = label * (F.log(label + 1e-12) - pred)
        return self._batch_mean(F, loss, sample_weight, self._weight)


class CTCLoss(Loss):
    """The CTC cost of each sample: ``pred`` (``layout`` NTC or TNC)
    against ``label`` (``label_layout`` NT or TN, padded with -1 or
    given ``label_lengths``), the blank the first class."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None,
                 **kwargs):
        super().__init__(weight, label_layout.find("N"), **kwargs)
        self._layout = layout
        self._label_layout = label_layout

    def hybrid_forward(self, F, pred, label, pred_lengths=None,
                       label_lengths=None, sample_weight=None):
        if self._layout == "NTC":
            pred = F.SwapAxis(pred, dim1=0, dim2=1)
        if self._batch_axis == 1:
            label = F.SwapAxis(label, dim1=0, dim2=1)
        extra = [x for x in (pred_lengths, label_lengths) if x is not None]
        loss = F.CTCLoss(pred, label, *extra,
                         use_data_lengths=pred_lengths is not None,
                         use_label_lengths=label_lengths is not None)
        return _apply_weighting(F, loss, self._weight, sample_weight)


class HuberLoss(Loss):
    """``|d| - rho / 2`` where ``|d| > rho``, else ``d^2 / (2 rho)``."""

    def __init__(self, rho=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        loss = F.abs(F.reshape_like(label, pred) - pred)
        loss = F.where(loss > self._rho, loss - 0.5 * self._rho,
                       (0.5 / self._rho) * F.square(loss))
        return self._batch_mean(F, loss, sample_weight, self._weight)


class HingeLoss(Loss):
    """``max(0, margin - pred * label)``."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        loss = F.relu(self._margin - pred * F.reshape_like(label, pred))
        return self._batch_mean(F, loss, sample_weight, self._weight)


class SquaredHingeLoss(Loss):
    """``max(0, margin - pred * label)^2``."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        loss = F.square(F.relu(self._margin
                               - pred * F.reshape_like(label, pred)))
        return self._batch_mean(F, loss, sample_weight, self._weight)


class LogisticLoss(Loss):
    """``log(1 + exp(-pred * label))`` for signed labels (or binary
    ones, ``label_format="binary"``)."""

    def __init__(self, weight=None, batch_axis=0, label_format="signed",
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        if label_format not in ("signed", "binary"):
            raise MXNetError("bad label_format %r" % label_format)
        self._label_format = label_format

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = F.reshape_like(label, pred)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        loss = F.relu(pred) - pred * label + _softrelu_of_minus_abs(F, pred)
        return self._batch_mean(F, loss, sample_weight, self._weight)


class TripletLoss(Loss):
    """``max(0, |pos - pred|^2 - |neg - pred|^2 + margin)`` a
    sample."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, positive, negative, sample_weight=None):
        positive = F.reshape_like(positive, pred)
        negative = F.reshape_like(negative, pred)
        loss = F.sum(F.square(positive - pred) - F.square(negative - pred),
                     axis=self._batch_axis, exclude=True)
        loss = F.relu(loss + self._margin)
        return _apply_weighting(F, loss, self._weight, sample_weight)


class PoissonNLLLoss(Loss):
    """The Poisson negative log-likelihood of ``target`` with the rate
    ``exp(pred)`` (``from_logits``) or ``pred``, with Stirling's term
    for targets above 1 under ``compute_full``; the mean of all."""

    def __init__(self, weight=None, from_logits=True, batch_axis=0,
                 compute_full=False, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._compute_full = compute_full

    def hybrid_forward(self, F, pred, target, sample_weight=None,
                       epsilon=1e-08):
        target = F.reshape_like(target, pred)
        if self._from_logits:
            loss = F.exp(pred) - target * pred
        else:
            loss = pred - target * F.log(pred + epsilon)
        if self._compute_full:
            stirling = target * F.log(target + 1e-12) - target + \
                0.5 * F.log(2 * np.pi * (target + 1e-12))
            loss = loss + stirling * (target > 1)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss)


class CosineEmbeddingLoss(Loss):
    """``1 - cos(input1, input2)`` for label 1, else ``max(0, cos -
    margin)``, over the last axis."""

    def __init__(self, weight=None, batch_axis=0, margin=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, input1, input2, label, sample_weight=None):
        cos = F.sum(input1 * input2, axis=-1) / (
            F.norm(input1, axis=-1) * F.norm(input2, axis=-1) + 1e-12)
        label = label.reshape((-1,))
        loss = F.where(label == 1, 1.0 - cos, F.relu(cos - self._margin))
        return _apply_weighting(F, loss, self._weight, sample_weight)
