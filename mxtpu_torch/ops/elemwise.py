"""Elementwise ops of the PyTorch port (counterpart of
``mxtpu/ops/elemwise.py``): the unary math, the same-shape binary ops,
the comparisons and logic, the scalar forms, ``add_n``, ``smooth_l1``,
the gradient stops and the ``broadcast_*`` family.

Where torch's default differs from the reference's, the reference
wins:

* a comparison or a logical op gives the left operand's dtype (1 or 0);
* a scalar form casts its scalar to the array's dtype first (an integer
  array takes the scalar truncated toward zero), then lets the
  operation promote as the reference's does (integer / integer is
  float32);
* ``_mod``, its scalar forms and ``broadcast_mod`` take the divisor's
  sign (``torch.remainder``, not ``fmod``);
* ``_maximum``/``_minimum`` split the gradient evenly at a tie;
* ``abs`` has the gradient 1 at 0 (torch's gives 0);
* ``round`` and ``rint`` round half to even;
* ``gamma`` is the reference's formula, ``exp(gammaln(x))`` with the
  sign of ``sin(pi x)`` for x <= 0;
* ``shape_array``/``size_array`` are int64, the port's index dtype,
  where the JAX package has int32 without x64.
"""
from __future__ import annotations

import math

import torch

from ..base import torch_dtype
from .registry import register


# ---------------------------------------------------------------------------
# unary
# ---------------------------------------------------------------------------

def _unary(name, f, differentiable=True, aliases=()):
    register(name, differentiable=differentiable, aliases=aliases)(
        lambda x, __f=f: __f(x))


def _cbrt(x):
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


def _abs(x):
    # the gradient at 0 is 1 (the reference's select(x >= 0, g, -g);
    # torch.abs gives 0), and + 0 makes -0.0 +0.0
    return torch.where(x >= 0, x, -x) + 0


def _gamma(x):
    sign = torch.sign(torch.where(x > 0, torch.ones_like(x),
                                  torch.sin(math.pi * x)))
    return torch.exp(torch.lgamma(x)) * sign


_unary("abs", _abs)
_unary("cbrt", _cbrt)
_unary("ceil", torch.ceil, differentiable=False)
_unary("cos", torch.cos)
_unary("cosh", torch.cosh)
_unary("degrees", torch.rad2deg)
_unary("erf", torch.erf)
_unary("erfinv", torch.erfinv)
_unary("exp", torch.exp)
_unary("expm1", torch.expm1)
_unary("fix", torch.trunc, differentiable=False)
_unary("floor", torch.floor, differentiable=False)
_unary("gamma", _gamma)
_unary("gammaln", torch.lgamma)
_unary("log", torch.log)
_unary("log10", torch.log10)
_unary("log1p", torch.log1p)
_unary("log2", torch.log2)
_unary("logical_not", lambda x: (x == 0).to(x.dtype), differentiable=False)
_unary("negative", torch.neg, aliases=("_np_negative",))
_unary("radians", torch.deg2rad)
_unary("rcbrt", lambda x: 1.0 / _cbrt(x))
_unary("reciprocal", lambda x: 1.0 / x)
_unary("rint", torch.round, differentiable=False)
_unary("round", torch.round, differentiable=False)
_unary("rsqrt", torch.rsqrt)
_unary("sign", torch.sign, differentiable=False)
_unary("sin", torch.sin)
_unary("sinh", torch.sinh)
_unary("sqrt", torch.sqrt)
_unary("square", torch.square)
_unary("tan", torch.tan)
_unary("tanh", torch.tanh)
_unary("trunc", torch.trunc, differentiable=False)
_unary("arccos", torch.arccos)
_unary("arccosh", torch.arccosh)
_unary("arcsin", torch.arcsin)
_unary("arcsinh", torch.arcsinh)
_unary("arctan", torch.arctan)
_unary("arctanh", torch.arctanh)


@register("_copy", aliases=("identity",))
def _copy(x):
    return x.clone()


@register("Cast", aliases=("cast",))
def _cast(x, dtype="float32"):
    return x.to(torch_dtype(dtype))


register("zeros_like")(lambda x: torch.zeros_like(x))
register("ones_like")(lambda x: torch.ones_like(x))


@register("shape_array", differentiable=False)
def _shape_array(x):
    return torch.tensor(x.shape, dtype=torch.int64, device=x.device)


@register("size_array", differentiable=False)
def _size_array(x):
    return torch.tensor([x.numel()], dtype=torch.int64, device=x.device)


@register("BlockGrad", aliases=("stop_gradient",))
def _block_grad(x):
    return x.detach()


@register("make_loss")
def _make_loss(x):
    return x


# ---------------------------------------------------------------------------
# binary (same shape) and broadcast: the same functions, both names
# ---------------------------------------------------------------------------

def _cmp(res, ref):
    return res.to(ref.dtype)


def _and(a, b):
    return _cmp((a != 0) & (b != 0), a)


def _or(a, b):
    return _cmp((a != 0) | (b != 0), a)


def _xor(a, b):
    return _cmp((a != 0) ^ (b != 0), a)


# name -> (function, differentiable, same-shape aliases, broadcast aliases)
_BINARY = {
    "add": (torch.add, True, ("elemwise_add", "_plus", "_add"),
            ("broadcast_add", "broadcast_plus")),
    "sub": (torch.sub, True, ("elemwise_sub", "_minus", "_sub"),
            ("broadcast_sub", "broadcast_minus")),
    "mul": (torch.mul, True, ("elemwise_mul", "_mul"), ("broadcast_mul",)),
    "div": (torch.div, True, ("elemwise_div", "_div"), ("broadcast_div",)),
    "grad_add": (torch.add, True, ("_grad_add",), ()),
    "hypot": (torch.hypot, True, ("_hypot",), ("broadcast_hypot",)),
    "power": (torch.pow, True, ("_power",), ("broadcast_power",)),
    "maximum": (torch.maximum, True, ("_maximum",), ("broadcast_maximum",)),
    "minimum": (torch.minimum, True, ("_minimum",), ("broadcast_minimum",)),
    "mod": (torch.remainder, True, ("_mod",), ("broadcast_mod",)),
    "equal": (lambda a, b: _cmp(a == b, a), False, ("_equal",),
              ("broadcast_equal",)),
    "not_equal": (lambda a, b: _cmp(a != b, a), False, ("_not_equal",),
                  ("broadcast_not_equal",)),
    "greater": (lambda a, b: _cmp(a > b, a), False, ("_greater",),
                ("broadcast_greater",)),
    "greater_equal": (lambda a, b: _cmp(a >= b, a), False,
                      ("_greater_equal",), ("broadcast_greater_equal",)),
    "lesser": (lambda a, b: _cmp(a < b, a), False, ("_lesser",),
               ("broadcast_lesser",)),
    "lesser_equal": (lambda a, b: _cmp(a <= b, a), False, ("_lesser_equal",),
                     ("broadcast_lesser_equal",)),
    "logical_and": (_and, False, ("_logical_and",),
                    ("broadcast_logical_and",)),
    "logical_or": (_or, False, ("_logical_or",), ("broadcast_logical_or",)),
    "logical_xor": (_xor, False, ("_logical_xor",),
                    ("broadcast_logical_xor",)),
}

for _f, _diff, _ew, _bc in _BINARY.values():
    for _names in (_ew, _bc):
        if _names:
            register(_names[0], differentiable=_diff, aliases=_names[1:])(
                lambda lhs, rhs, __f=_f: __f(lhs, rhs))


@register("add_n", aliases=("ElementWiseSum", "_sum_of"))
def _add_n(*args, num_args=None):
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out


# ---------------------------------------------------------------------------
# scalar forms: attr ``scalar``, cast to the array's dtype first
# ---------------------------------------------------------------------------

def _sc(x, s):
    if x.dtype.is_floating_point or x.dtype.is_complex:
        return float(s)
    if x.dtype == torch.bool:
        return bool(s)
    return int(s)


def _scalar_op(name, f):
    def op(x, scalar=0.0):
        return f(x, _sc(x, scalar))

    register(name)(op)


def _full(x, s):
    return torch.full((), s, dtype=x.dtype, device=x.device)


_scalar_op("_plus_scalar", lambda x, s: x + s)
_scalar_op("_minus_scalar", lambda x, s: x - s)
_scalar_op("_rminus_scalar", lambda x, s: s - x)
_scalar_op("_mul_scalar", lambda x, s: x * s)
_scalar_op("_div_scalar", lambda x, s: x / s)
_scalar_op("_rdiv_scalar", lambda x, s: s / x)
_scalar_op("_mod_scalar", lambda x, s: torch.remainder(x, s))
_scalar_op("_rmod_scalar", lambda x, s: torch.remainder(_full(x, s), x))
_scalar_op("_power_scalar", lambda x, s: torch.pow(x, s))
_scalar_op("_rpower_scalar", lambda x, s: torch.pow(s, x))
_scalar_op("_hypot_scalar", lambda x, s: torch.hypot(x, _full(x, s)))
_scalar_op("_maximum_scalar", lambda x, s: torch.maximum(x, _full(x, s)))
_scalar_op("_minimum_scalar", lambda x, s: torch.minimum(x, _full(x, s)))
_scalar_op("_scatter_plus_scalar", lambda x, s: x + s)
_scalar_op("_scatter_minus_scalar", lambda x, s: x - s)


def _cmp_scalar(name, f):
    # the comparisons take the scalar as it is, as the reference's do
    register(name, differentiable=False)(
        lambda x, scalar=0.0: f(x, scalar).to(x.dtype))


_cmp_scalar("_equal_scalar", lambda x, s: x == s)
_cmp_scalar("_not_equal_scalar", lambda x, s: x != s)
_cmp_scalar("_greater_scalar", lambda x, s: x > s)
_cmp_scalar("_greater_equal_scalar", lambda x, s: x >= s)
_cmp_scalar("_lesser_scalar", lambda x, s: x < s)
_cmp_scalar("_lesser_equal_scalar", lambda x, s: x <= s)
_cmp_scalar("_logical_and_scalar", lambda x, s: (x != 0) & (s != 0))
_cmp_scalar("_logical_or_scalar", lambda x, s: (x != 0) | (s != 0))
_cmp_scalar("_logical_xor_scalar", lambda x, s: (x != 0) ^ (s != 0))


@register("smooth_l1")
def _smooth_l1(x, scalar=1.0):
    sigma2 = scalar * scalar
    absx = torch.abs(x)
    return torch.where(absx < 1.0 / sigma2, 0.5 * sigma2 * x * x,
                       absx - 0.5 / sigma2)


# ---------------------------------------------------------------------------
# broadcasting to a shape
# ---------------------------------------------------------------------------

@register("broadcast_axis", aliases=("broadcast_axes",))
def _broadcast_axis(x, axis=(), size=()):
    axis = (axis,) if isinstance(axis, int) else axis
    size = (size,) if isinstance(size, int) else size
    shape = list(x.shape)
    for a, s in zip(axis, size):
        shape[a] = s
    return x.expand(tuple(shape))


@register("broadcast_to")
def _broadcast_to(x, shape=()):
    # 0 in the target keeps the input's dimension
    return x.expand(tuple(int(i) if int(t) == 0 else int(t)
                          for i, t in zip(x.shape, shape)))


@register("broadcast_like")
def _broadcast_like(x, other):
    return torch.broadcast_to(x, other.shape)
