"""Basic layers of the PyTorch port (counterpart of
``mxtpu/gluon/nn/basic_layers.py``): Sequential, HybridSequential,
Dense, Dropout, BatchNorm, Embedding, Flatten, Lambda, HybridLambda
and Activation.  LayerNorm, InstanceNorm and the LeakyReLU family wait
for their ops (ROADMAP A13/A14); Embedding's row-sparse gradient
(``sparse_grad=True``) raises (ROADMAP A10c).

BatchNorm keeps gluon's defaults (``momentum`` 0.9, ``epsilon`` 1e-5,
``scale=True``, so ``fix_gamma`` False where the symbol's default is
True); its running statistics are ``grad_req="null"`` Parameters, aux
states of the traced graph.  Imperatively in training it folds them
itself, ``m * old + (1 - m) * batch`` (the batch's biased variance),
as the executor's walk does for the traced graph.
"""
from __future__ import annotations

import numpy as np

from ...base import MXNetError
from ..block import Block, HybridBlock

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout", "BatchNorm",
           "Embedding", "Flatten", "Lambda", "HybridLambda", "Activation"]


class _Stack(object):
    """What Sequential and HybridSequential share."""

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def __len__(self):
        return len(self._children)

    def __getitem__(self, key):
        layers = list(self._children.values())[key]
        if isinstance(layers, list):
            net = type(self)()
            net.add(*layers)
            return net
        return layers

    def __iter__(self):
        return iter(self._children.values())


class Sequential(_Stack, Block):
    """Blocks run one after another."""

    def __init__(self, prefix=None, params=None):
        Block.__init__(self, prefix=prefix, params=params)

    def forward(self, x):
        for block in self._children.values():
            x = block(x)
        return x


class HybridSequential(_Stack, HybridBlock):
    """HybridBlocks run one after another."""

    def __init__(self, prefix=None, params=None):
        HybridBlock.__init__(self, prefix=prefix, params=params)

    def hybrid_forward(self, F, x):
        for block in self._children.values():
            x = block(x)
        return x


class Dense(HybridBlock):
    """A fully connected layer, ``act(x W^T + b)``."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self._units = units
            self._flatten = flatten
            self.weight = self.params.get(
                "weight", shape=(units, in_units), init=weight_initializer,
                dtype=dtype, allow_deferred_init=True)
            self.bias = self.params.get(
                "bias", shape=(units,), init=bias_initializer, dtype=dtype,
                allow_deferred_init=True) if use_bias else None
            self.act = Activation(activation, prefix=activation + "_") \
                if activation is not None else None

    def hybrid_forward(self, F, x, weight, bias=None):
        if bias is None:
            out = F.FullyConnected(x, weight, num_hidden=self._units,
                                   no_bias=True, flatten=self._flatten)
        else:
            out = F.FullyConnected(x, weight, bias, num_hidden=self._units,
                                   flatten=self._flatten)
        return self.act(out) if self.act is not None else out


class Dropout(HybridBlock):
    """Zeroes each element (or slice along ``axes``) with probability
    ``rate`` in training and scales the rest by 1 / (1 - rate)."""

    def __init__(self, rate, axes=(), **kwargs):
        super().__init__(**kwargs)
        self._rate = rate
        self._axes = axes

    def hybrid_forward(self, F, x):
        if self._rate > 0:
            return F.Dropout(x, p=self._rate, axes=self._axes)
        return F._copy(x)


class BatchNorm(HybridBlock):
    """Batch normalization over ``axis``."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones", running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self._kwargs = {"axis": axis, "eps": epsilon,
                            "momentum": momentum, "fix_gamma": not scale,
                            "use_global_stats": use_global_stats}
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True)
            self.running_mean = self.params.get(
                "running_mean", grad_req="null", shape=(in_channels,),
                init=running_mean_initializer, allow_deferred_init=True,
                differentiable=False)
            self.running_var = self.params.get(
                "running_var", grad_req="null", shape=(in_channels,),
                init=running_variance_initializer, allow_deferred_init=True,
                differentiable=False)

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        from ... import autograd as _ag
        from ... import ndarray as _nd

        if F is not _nd:
            return F.BatchNorm(x, gamma, beta, running_mean, running_var,
                               **self._kwargs)
        out, mean, var = _nd.imperative_invoke(
            "BatchNorm", x, gamma, beta, running_mean, running_var,
            _full_outputs=True, **self._kwargs)
        if _ag.is_training() and not self._kwargs["use_global_stats"]:
            m = self._kwargs["momentum"]
            for stat, batch in ((running_mean, mean), (running_var, var)):
                stat._set_data(m * stat._data
                               + (1 - m) * batch._data.detach())
        return out

    def cast(self, dtype):
        if np.dtype(dtype) == np.float16:
            dtype = "float32"  # the statistics stay float32
        super().cast(dtype)


class Embedding(HybridBlock):
    """A lookup table: ids (any shape) -> their rows of ``weight``
    (input_dim, output_dim); out-of-range ids are clipped."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, **kwargs):
        super().__init__(**kwargs)
        if sparse_grad:
            raise MXNetError("Embedding(sparse_grad=True) needs row-sparse "
                             "gradients, which are not ported (ROADMAP "
                             "A10c, A14)")
        with self.name_scope():
            self._kwargs = {"input_dim": input_dim, "output_dim": output_dim,
                            "dtype": dtype}
            self.weight = self.params.get(
                "weight", shape=(input_dim, output_dim),
                init=weight_initializer, dtype=dtype,
                allow_deferred_init=True)

    def hybrid_forward(self, F, x, weight):
        return F.Embedding(x, weight, **self._kwargs)


class Flatten(HybridBlock):
    """(N, ...) -> (N, product of the rest)."""

    def hybrid_forward(self, F, x):
        return F.Flatten(x)


class Lambda(Block):
    """A function (or the name of an ``nd`` function) as a Block."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        from ... import ndarray as _nd

        if isinstance(function, str):
            if not hasattr(_nd, function):
                raise MXNetError("function %r not found in nd" % function)
            function = getattr(_nd, function)
        self._func_impl = function

    def forward(self, *args):
        return self._func_impl(*args)


class HybridLambda(HybridBlock):
    """``function(F, *args)`` (or the name of an op) as a
    HybridBlock."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        self._function = function

    def hybrid_forward(self, F, *args):
        if isinstance(self._function, str):
            return getattr(F, self._function)(*args)
        return self._function(F, *args)


class Activation(HybridBlock):
    """An elementwise activation (``relu``, ``sigmoid``, ``tanh``,
    ``softrelu``, ``softsign``)."""

    def __init__(self, activation, **kwargs):
        self._act_type = activation
        super().__init__(**kwargs)

    def _alias(self):
        return self._act_type

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type)
