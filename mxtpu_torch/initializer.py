"""Weight initializers of the PyTorch port.

Counterpart of ``mxtpu/initializer.py``: ``InitDesc``, the dispatch by
parameter name (weight, bias, gamma, beta, moving_mean, moving_var, or
an ``__init__`` attr), ``Uniform``, ``Normal``, ``Xavier``, ``Zero``,
``One``, ``Constant``, ``LSTMBias``, ``register`` and ``create``.
Random draws come from ``mxtpu_torch.random`` on the array's own
device, so the values differ from the JAX package's for the same seed;
the distributions are the same.  ``Load``, ``Mixed``, ``Orthogonal``,
``MSRAPrelu`` and ``Bilinear`` are not ported.
"""
from __future__ import annotations

import json
import math
from typing import Dict

import numpy as np
import torch

from .base import MXNetError

__all__ = ["InitDesc", "Initializer", "Uniform", "Normal", "Zero", "One",
           "Constant", "Xavier", "LSTMBias", "register", "create"]

_INIT_REGISTRY: Dict[str, type] = {}


def register(klass):
    _INIT_REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs) -> "Initializer":
    if isinstance(name, Initializer) or callable(name):
        return name
    key = str(name).lower()
    if key not in _INIT_REGISTRY:
        raise MXNetError("unknown initializer %r" % name)
    return _INIT_REGISTRY[key](**kwargs)


class InitDesc(str):
    """Parameter name plus its attrs."""

    def __new__(cls, name, attrs=None, global_init=None):
        obj = super().__new__(cls, name)
        obj.attrs = attrs or {}
        obj.global_init = global_init
        return obj


class Initializer(object):
    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, desc, arr):
        """Fill the NDArray ``arr`` by what its name ends with."""
        if not isinstance(desc, InitDesc):
            desc = InitDesc(str(desc))
        init_hint = desc.attrs.get("__init__", "")
        if init_hint:
            if init_hint.startswith("["):
                hint_name, hint_kwargs = json.loads(init_hint)
                init = create(hint_name, **(hint_kwargs or {}))
            else:
                init = create(init_hint)
            init._init_weight(desc, arr)
            return
        name = desc.lower()
        if name.endswith("weight"):
            self._init_weight(desc, arr)
        elif name.endswith("bias"):
            self._init_bias(desc, arr)
        elif name.endswith("gamma"):
            self._init_gamma(desc, arr)
        elif name.endswith("beta"):
            self._init_beta(desc, arr)
        elif name.endswith("moving_mean") or name.endswith("running_mean"):
            self._init_zero(desc, arr)
        elif name.endswith("moving_var") or name.endswith("running_var"):
            self._init_one(desc, arr)
        elif name.endswith("moving_inv_var") or name.endswith("moving_avg"):
            self._init_zero(desc, arr)
        else:
            self._init_default(desc, arr)

    def init_weight(self, desc, arr):
        self._init_weight(desc, arr)

    # -- helpers ----------------------------------------------------------
    @staticmethod
    def _set(arr, value):
        """Write ``value`` (a tensor, a numpy array or a number) into the
        NDArray ``arr`` in place."""
        if not isinstance(value, torch.Tensor):
            value = torch.as_tensor(np.asarray(value, dtype=np.float32))
        with torch.no_grad():
            arr._data.copy_(value.expand(arr.shape))

    @staticmethod
    def _rand_uniform(arr, low, high):
        from . import random as _rnd

        return _rnd.uniform(low, high, shape=arr.shape, ctx=arr.ctx)._data

    @staticmethod
    def _rand_normal(arr, sigma):
        from . import random as _rnd

        return _rnd.normal(0.0, sigma, shape=arr.shape, ctx=arr.ctx)._data

    def _init_zero(self, desc, arr):
        self._set(arr, 0.0)

    def _init_one(self, desc, arr):
        self._set(arr, 1.0)

    def _init_bias(self, desc, arr):
        self._init_zero(desc, arr)

    def _init_gamma(self, desc, arr):
        self._init_one(desc, arr)

    def _init_beta(self, desc, arr):
        self._init_zero(desc, arr)

    def _init_weight(self, desc, arr):
        raise NotImplementedError

    def _init_default(self, desc, arr):
        self._init_weight(desc, arr)

    def dumps(self) -> str:
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __repr__(self):
        return "%s(%s)" % (self.__class__.__name__, self._kwargs)


@register
class Zero(Initializer):
    def _init_weight(self, desc, arr):
        self._init_zero(desc, arr)


_INIT_REGISTRY["zeros"] = Zero


@register
class One(Initializer):
    def _init_weight(self, desc, arr):
        self._init_one(desc, arr)


_INIT_REGISTRY["ones"] = One


@register
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, desc, arr):
        self._set(arr, float(self.value))


@register
class Uniform(Initializer):
    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, desc, arr):
        self._set(arr, self._rand_uniform(arr, -self.scale, self.scale))


@register
class Normal(Initializer):
    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, desc, arr):
        self._set(arr, self._rand_normal(arr, self.sigma))


@register
class Xavier(Initializer):
    """uniform(-s, s) or normal(0, s) with ``s = sqrt(magnitude /
    factor)``, the factor from the fans (``hw_scale``, the product of
    the kernel dims, multiplies both)."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, desc, arr):
        shape = arr.shape
        if len(shape) < 2:
            raise MXNetError("Xavier initializer needs >= 2D weight, got %s "
                             "for %s" % (shape, desc))
        hw_scale = float(np.prod(shape[2:])) if len(shape) > 2 else 1.0
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        if self.factor_type == "avg":
            factor = (fan_in + fan_out) / 2.0
        elif self.factor_type == "in":
            factor = fan_in
        elif self.factor_type == "out":
            factor = fan_out
        else:
            raise MXNetError("bad factor_type %r" % self.factor_type)
        scale = math.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            self._set(arr, self._rand_uniform(arr, -scale, scale))
        else:
            self._set(arr, self._rand_normal(arr, scale))


@register
class LSTMBias(Initializer):
    """Zeros, and ``forget_bias`` in the forget gate's quarter (gates i,
    f, g, o): the i2h bias of ``rnn.LSTMCell``."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, desc, arr):
        b = np.zeros(arr.shape, dtype=np.float32)
        n = arr.shape[0] // 4
        b[n:2 * n] = self.forget_bias
        self._set(arr, b)

    _init_default = _init_weight
    _init_bias = _init_weight
