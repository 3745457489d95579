"""Evaluation metrics of the PyTorch port (counterpart of
``mxtpu/metric.py``: its registry, aliases and classes, ``np`` and
``create``).  Every metric but Perplexity reads its arrays on the host,
as the JAX package's do; Perplexity reduces on the arrays' device and
moves two numbers a batch, where the JAX package moves every prediction
(77 MB a batch at bucket 60 of a 10,000-word vocabulary)."""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import numpy as _np
import torch

from .base import MXNetError

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "F1", "MCC", "Perplexity", "MAE", "MSE", "RMSE", "CrossEntropy",
           "NegativeLogLikelihood", "PearsonCorrelation", "Loss", "Torch",
           "Caffe", "CustomMetric", "np", "create"]

_METRIC_REGISTRY: Dict[str, type] = {}


def register(klass):
    _METRIC_REGISTRY[klass.__name__.lower()] = klass
    return klass


def _alias(name, klass):
    _METRIC_REGISTRY[name] = klass


def create(metric, *args, **kwargs):
    """A metric from a name, an instance, a list of them (a composite)
    or a function of (label, pred) (a ``CustomMetric``)."""
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
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


def check_label_shapes(labels, preds, wrap=False, shape=False):
    """Raise unless there are as many labels as predictions (with
    ``shape``, unless their shapes agree); with ``wrap`` a single array
    becomes a list of one."""
    if not shape:
        label_shape, pred_shape = len(labels), len(preds)
    else:
        label_shape, pred_shape = labels.shape, preds.shape
    if label_shape != pred_shape:
        raise ValueError("Shape of labels {} does not match shape of "
                         "predictions {}".format(label_shape, pred_shape))
    if wrap:
        if not isinstance(labels, (list, tuple)):
            labels = [labels]
        if not isinstance(preds, (list, tuple)):
            preds = [preds]
    return labels, preds


class EvalMetric(object):
    def __init__(self, name, output_names: Optional[List[str]] = None,
                 label_names: Optional[List[str]] = None, **kwargs: Any):
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

    def update_dict(self, label, pred):
        """``update`` from dicts of outputs and labels by name (every
        value where no names were given)."""
        pred = [pred[n] for n in self.output_names] \
            if self.output_names is not None else list(pred.values())
        label = [label[n] for n in self.label_names] \
            if self.label_names is not None else list(label.values())
        self.update(label, pred)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_config(self):
        config = {"metric": self.__class__.__name__, "name": self.name}
        config.update(self._kwargs)
        return config

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

    def get_metric(self, index):
        return self.metrics[index]

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def update_dict(self, labels, preds):
        for metric in self.metrics:
            metric.update_dict(labels, preds)

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
        labels, preds = check_label_shapes(labels, preds, wrap=True)
        for label, pred in zip(labels, preds):
            label = _asnumpy(label).astype(_np.int32)
            pred = _asnumpy(pred)
            if pred.ndim > label.ndim:
                pred = pred.argmax(axis=self.axis)
            pred = pred.astype(_np.int32)
            self.sum_metric += (pred.flat == label.flat).sum()
            self.num_inst += len(label.flat)


acc = _alias("acc", Accuracy)


@register
class TopKAccuracy(EvalMetric):
    """The share of labels among the ``top_k`` largest predictions
    (``numpy.argpartition`` on the host, as the JAX package's)."""

    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None,
                 label_names=None):
        super().__init__("%s_%d" % (name, top_k), output_names, label_names,
                         top_k=top_k)
        self.top_k = top_k

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, wrap=True)
        for label, pred in zip(labels, preds):
            label = _asnumpy(label).astype(_np.int32)
            pred = _asnumpy(pred)
            topk = _np.argpartition(pred, -self.top_k,
                                    axis=-1)[..., -self.top_k:]
            for k in range(self.top_k):
                self.sum_metric += (topk[..., k].flat == label.flat).sum()
            self.num_inst += len(label.flat)


_alias("top_k_acc", TopKAccuracy)
_alias("top_k_accuracy", TopKAccuracy)


class _BinaryClassificationMetrics(object):
    """True and false positives and negatives of a binary classifier
    (the argmax of two columns, or a probability above 0.5)."""

    def __init__(self):
        self.tp = self.fp = self.tn = self.fn = 0

    def update(self, label, pred):
        pred_label = pred.argmax(axis=1) if pred.ndim > 1 else (pred > 0.5)
        label = label.astype(_np.int32).reshape(-1)
        pred_label = pred_label.astype(_np.int32).reshape(-1)
        self.tp += int(((pred_label == 1) & (label == 1)).sum())
        self.fp += int(((pred_label == 1) & (label == 0)).sum())
        self.tn += int(((pred_label == 0) & (label == 0)).sum())
        self.fn += int(((pred_label == 0) & (label == 1)).sum())

    @property
    def precision(self):
        return self.tp / max(self.tp + self.fp, 1)

    @property
    def recall(self):
        return self.tp / max(self.tp + self.fn, 1)

    @property
    def fscore(self):
        p, r = self.precision, self.recall
        return 2 * p * r / max(p + r, 1e-12)

    @property
    def matthewscc(self):
        num = self.tp * self.tn - self.fp * self.fn
        den = math.sqrt(max((self.tp + self.fp) * (self.tp + self.fn) *
                            (self.tn + self.fp) * (self.tn + self.fn), 1))
        return num / den

    @property
    def total_examples(self):
        return self.tp + self.fp + self.tn + self.fn

    def reset_stats(self):
        self.tp = self.fp = self.tn = self.fn = 0


@register
class F1(EvalMetric):
    """F1 of a binary classifier over everything seen (``macro``) or,
    with ``micro``, weighted by the examples."""

    def __init__(self, name="f1", output_names=None, label_names=None,
                 average="macro"):
        self.average = average
        self.metrics = _BinaryClassificationMetrics()
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, wrap=True)
        for label, pred in zip(labels, preds):
            self.metrics.update(_asnumpy(label), _asnumpy(pred))
        if self.average == "micro":
            self.sum_metric = self.metrics.fscore * \
                self.metrics.total_examples
            self.num_inst = self.metrics.total_examples

    def get(self):
        if self.average == "micro":
            return super().get()
        return (self.name, self.metrics.fscore)

    def reset(self):
        super().reset()
        if hasattr(self, "metrics"):
            self.metrics.reset_stats()


@register
class MCC(EvalMetric):
    """Matthews' correlation coefficient of a binary classifier."""

    def __init__(self, name="mcc", output_names=None, label_names=None,
                 average="macro"):
        self.metrics = _BinaryClassificationMetrics()
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, wrap=True)
        for label, pred in zip(labels, preds):
            self.metrics.update(_asnumpy(label), _asnumpy(pred))

    def get(self):
        return (self.name, self.metrics.matthewscc)

    def reset(self):
        super().reset()
        if hasattr(self, "metrics"):
            self.metrics.reset_stats()


def _regression_pairs(labels, preds):
    """(label, pred) host pairs, a 1-D label against a 2-D prediction
    made a column."""
    labels, preds = check_label_shapes(labels, preds, wrap=True)
    for label, pred in zip(labels, preds):
        label, pred = _asnumpy(label), _asnumpy(pred)
        if label.ndim == 1 and pred.ndim == 2:
            label = label.reshape(label.shape[0], 1)
        yield label, pred


@register
class MAE(EvalMetric):
    def __init__(self, name="mae", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        for label, pred in _regression_pairs(labels, preds):
            self.sum_metric += _np.abs(label - pred).mean()
            self.num_inst += 1


@register
class MSE(EvalMetric):
    def __init__(self, name="mse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        for label, pred in _regression_pairs(labels, preds):
            self.sum_metric += ((label - pred) ** 2.0).mean()
            self.num_inst += 1


@register
class RMSE(EvalMetric):
    def __init__(self, name="rmse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        for label, pred in _regression_pairs(labels, preds):
            self.sum_metric += math.sqrt(((label - pred) ** 2.0).mean())
            self.num_inst += 1


@register
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, eps=eps)
        self.eps = eps

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, wrap=True)
        for label, pred in zip(labels, preds):
            label = _asnumpy(label).ravel().astype(_np.int64)
            pred = _asnumpy(pred)
            if label.shape[0] != pred.shape[0]:
                raise MXNetError("labels and predictions disagree on the "
                                 "batch size")
            prob = pred[_np.arange(label.shape[0]), label]
            self.sum_metric += (-_np.log(prob + self.eps)).sum()
            self.num_inst += label.shape[0]


_alias("ce", CrossEntropy)


@register
class NegativeLogLikelihood(EvalMetric):
    def __init__(self, eps=1e-12, name="nll-loss", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, eps=eps)
        self.eps = eps

    update = CrossEntropy.update


_alias("nll_loss", NegativeLogLikelihood)


@register
class PearsonCorrelation(EvalMetric):
    def __init__(self, name="pearsonr", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, wrap=True)
        for label, pred in zip(labels, preds):
            self.sum_metric += _np.corrcoef(_asnumpy(pred).ravel(),
                                            _asnumpy(label).ravel())[0, 1]
            self.num_inst += 1


@register
class Loss(EvalMetric):
    """The mean of the raw loss outputs (labels ignored)."""

    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, _, preds):
        if not isinstance(preds, (list, tuple)):
            preds = [preds]
        for pred in preds:
            loss = _asnumpy(pred)
            self.sum_metric += loss.sum()
            self.num_inst += loss.size


class Torch(Loss):
    def __init__(self, name="torch", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


class Caffe(Loss):
    def __init__(self, name="caffe", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register
class CustomMetric(EvalMetric):
    """A metric from ``feval(label, pred)`` on host arrays, which
    returns a value a batch or (sum, count)."""

    def __init__(self, feval, name=None, allow_extra_outputs=False,
                 output_names=None, label_names=None):
        if name is None:
            name = feval.__name__
            if name.find("<") != -1:
                name = "custom(%s)" % name
        super().__init__(name, output_names, label_names)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            labels, preds = check_label_shapes(labels, preds, wrap=True)
        for label, pred in zip(labels, preds):
            reval = self._feval(_asnumpy(label), _asnumpy(pred))
            if isinstance(reval, tuple):
                sum_metric, num_inst = reval
                self.sum_metric += sum_metric
                self.num_inst += num_inst
            else:
                self.sum_metric += reval
                self.num_inst += 1


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """A ``CustomMetric`` of a function of numpy arrays."""

    def feval(label, pred):
        return numpy_feval(label, pred)

    feval.__name__ = numpy_feval.__name__
    return CustomMetric(feval, name, allow_extra_outputs)


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
