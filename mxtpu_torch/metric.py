"""Evaluation metrics of the PyTorch port (counterpart of
``EvalMetric``, ``CompositeEvalMetric``, ``Accuracy``, ``CrossEntropy``
and ``Perplexity`` in ``mxtpu/metric.py``).  Accuracy and CrossEntropy
read their arrays on the host; Perplexity reduces on the arrays' device
and moves two numbers a batch, where the JAX package moves every
prediction (77 MB a batch at bucket 60 of a 10,000-word vocabulary)."""
from __future__ import annotations

import math
from typing import Dict

import numpy as _np
import torch

from .base import MXNetError

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "CrossEntropy",
           "Perplexity", "create"]

_METRIC_REGISTRY: Dict[str, type] = {}


def register(klass):
    _METRIC_REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(metric, *args, **kwargs):
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, (list, tuple)):
        composite = CompositeEvalMetric()
        for m in metric:
            composite.add(create(m, *args, **kwargs))
        return composite
    key = str(metric).lower()
    if key not in _METRIC_REGISTRY:
        raise MXNetError("unknown metric %r" % metric)
    return _METRIC_REGISTRY[key](*args, **kwargs)


def _asnumpy(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else _np.asarray(x)


def check_label_shapes(labels, preds):
    if len(labels) != len(preds):
        raise ValueError("Shape of labels {} does not match shape of "
                         "predictions {}".format(len(labels), len(preds)))
    return labels, preds


class EvalMetric(object):
    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        raise NotImplementedError

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name, value = [name], [value]
        return list(zip(name, value))

    def __str__(self):
        return "EvalMetric: {}".format(dict(self.get_name_value()))


@register
class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite", output_names=None,
                 label_names=None):
        self.metrics = [create(m) for m in (metrics or [])]
        super().__init__(name, output_names, label_names)

    def add(self, metric):
        self.metrics.append(create(metric))

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def reset(self):
        for metric in getattr(self, "metrics", []):
            metric.reset()
        super().reset()

    def get(self):
        names, values = [], []
        for metric in self.metrics:
            for n, v in metric.get_name_value():
                names.append(n)
                values.append(v)
        return names, values


@register
class Accuracy(EvalMetric):
    def __init__(self, axis=1, name="accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, axis=axis)
        self.axis = axis

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = _asnumpy(label).astype(_np.int32)
            pred = _asnumpy(pred)
            if pred.ndim > label.ndim:
                pred = pred.argmax(axis=self.axis)
            pred = pred.astype(_np.int32)
            self.sum_metric += (pred.flat == label.flat).sum()
            self.num_inst += len(label.flat)


_METRIC_REGISTRY["acc"] = Accuracy


@register
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, eps=eps)
        self.eps = eps

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = _asnumpy(label).ravel().astype(_np.int64)
            pred = _asnumpy(pred)
            if label.shape[0] != pred.shape[0]:
                raise MXNetError("labels and predictions disagree on the "
                                 "batch size")
            prob = pred[_np.arange(label.shape[0]), label]
            self.sum_metric += (-_np.log(prob + self.eps)).sum()
            self.num_inst += label.shape[0]


_METRIC_REGISTRY["ce"] = CrossEntropy


def _as_tensor(x, device=None):
    t = x._data if hasattr(x, "_data") else torch.as_tensor(_np.asarray(x))
    return t.detach() if device is None else t.detach().to(device)


@register
class Perplexity(EvalMetric):
    """exp of the mean negative log-probability of the labels, the
    labels equal to ``ignore_label`` left out; each prediction is read
    as (number of labels, classes), its probabilities clipped at 1e-10
    below, as the JAX package's."""

    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 output_names=None, label_names=None):
        super().__init__(name, output_names, label_names,
                         ignore_label=ignore_label)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        if not isinstance(labels, (list, tuple)):
            labels = [labels]
        if not isinstance(preds, (list, tuple)):
            preds = [preds]
        labels, preds = check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            pred = _as_tensor(pred)
            label = _as_tensor(label, pred.device).long().reshape(-1)
            ignore = torch.zeros_like(label, dtype=torch.bool)
            if self.ignore_label is not None:
                ignore = label == int(self.ignore_label)
            # an ignored label may lie outside the classes (-1)
            probs = pred.reshape(label.numel(), -1).gather(
                1, label.masked_fill(ignore, 0)[:, None])[:, 0]
            probs = torch.where(ignore, torch.ones_like(probs), probs)
            ignored = ignore.sum()
            loss = -torch.log(probs.clamp(min=1e-10)).double().sum()
            loss, n_ignored = torch.stack([loss, ignored.double()]).tolist()
            self.sum_metric += loss
            self.num_inst += label.numel() - int(n_ignored)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.exp(self.sum_metric / self.num_inst))
