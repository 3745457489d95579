"""Elementwise ops of the PyTorch port.

Counterpart of the part of ``mxtpu/ops/elemwise.py`` that the ResNet
graph, NDArray's operators, the metrics and gluon's losses use: the
binary ops (``elemwise_add`` with its aliases ``_plus``/``_add``, sub,
mul, div), their broadcasting forms, the scalar forms with
``_greater_scalar``, the unary ``negative``, ``abs``, ``square``,
``log`` and ``exp``, ``Cast`` and ``_copy``.
"""
from __future__ import annotations

import torch

from ..base import torch_dtype
from .registry import register


def _binary(name, f, aliases=()):
    register(name, aliases=aliases)(f)


_binary("elemwise_add", lambda a, b: a + b, aliases=("_plus", "_add"))
_binary("elemwise_sub", lambda a, b: a - b, aliases=("_minus", "_sub"))
_binary("elemwise_mul", lambda a, b: a * b, aliases=("_mul",))
_binary("elemwise_div", lambda a, b: a / b, aliases=("_div",))
_binary("broadcast_add", lambda a, b: a + b, aliases=("broadcast_plus",))
_binary("broadcast_sub", lambda a, b: a - b, aliases=("broadcast_minus",))
_binary("broadcast_mul", lambda a, b: a * b)
_binary("broadcast_div", lambda a, b: a / b)


def _scalar_op(name, f):
    def op(x, scalar=0.0):
        # the result keeps the array's dtype, as the reference's does
        return f(x, scalar).to(x.dtype)

    register(name)(op)


_scalar_op("_plus_scalar", lambda x, s: x + s)
_scalar_op("_minus_scalar", lambda x, s: x - s)
_scalar_op("_rminus_scalar", lambda x, s: s - x)
_scalar_op("_mul_scalar", lambda x, s: x * s)
_scalar_op("_div_scalar", lambda x, s: x / s)
_scalar_op("_rdiv_scalar", lambda x, s: s / x)
_scalar_op("_power_scalar", lambda x, s: torch.pow(x, s))


register("_greater_scalar", differentiable=False)(
    lambda x, scalar=0.0: (x > scalar).to(x.dtype))


@register("negative")
def _negative(x):
    return -x


register("abs")(lambda x: x.abs())
register("square")(lambda x: torch.square(x))
register("log")(lambda x: x.log())
register("exp")(lambda x: x.exp())


@register("_copy", aliases=("identity",))
def _copy(x):
    return x.clone()


@register("Cast", aliases=("cast",))
def _cast(x, dtype="float32"):
    return x.to(torch_dtype(dtype))
