"""Reductions of the PyTorch port (counterpart of
``mxtpu/ops/reduce.py``): ``sum``, ``mean``, ``prod``, ``nansum``,
``nanprod``, ``max``, ``min``, ``norm``, ``_square_sum``, ``argmax``,
``argmin``, ``argmax_channel`` and ``pick``.

``max``/``min`` are ``torch.amax``/``amin``, which split the gradient
evenly over tied maxima as the reference's does (``torch.max(dim)``
gives all of it to one).  An empty axis tuple reduces nothing (torch
reads ``dim=()`` as every axis).  The index results are float32, as
the reference's are.
"""
from __future__ import annotations

import torch

from .registry import register


def _axes(axis, exclude=False, ndim=None):
    if axis is None:
        ax = None
    elif isinstance(axis, int):
        ax = (axis,)
    else:
        ax = tuple(axis)
    if exclude and ax is not None:
        ax = tuple(i for i in range(ndim) if i not in {a % ndim for a in ax})
    return ax


def _over_one_axis(f, x, ax, kd):
    """``f(t, dim)`` over the axes ``ax`` at once, for torch reductions
    that take a single dim: the axes are moved to the end and merged."""
    ax = sorted(a % x.ndim for a in ax)
    rest = [a for a in range(x.ndim) if a not in ax]
    y = f(x.permute(*rest, *ax).reshape(
        [x.shape[a] for a in rest] + [-1]), -1)
    if kd:
        y = y.reshape([1 if a in ax else x.shape[a] for a in range(x.ndim)])
    return y


def _nanprod(t, dim):
    return torch.where(torch.isnan(t), torch.ones_like(t), t).prod(dim)


_REDUCERS = {
    "sum": lambda x, ax, kd: x.sum(dim=ax, keepdim=kd),
    "mean": lambda x, ax, kd: x.mean(dim=ax, keepdim=kd),
    "prod": lambda x, ax, kd: _over_one_axis(torch.prod, x, ax, kd),
    "nansum": lambda x, ax, kd: torch.nansum(x, dim=ax, keepdim=kd),
    "nanprod": lambda x, ax, kd: _over_one_axis(_nanprod, x, ax, kd),
    "max": lambda x, ax, kd: torch.amax(x, dim=ax, keepdim=kd),
    "min": lambda x, ax, kd: torch.amin(x, dim=ax, keepdim=kd),
}


def _reduce_op(name, f):
    def op(x, axis=None, keepdims=False, exclude=False):
        ax = _axes(axis, exclude, x.ndim)
        if ax is None:
            ax = tuple(range(x.ndim))
        if not ax:
            return x.clone()
        return f(x, ax, keepdims)

    register(name)(op)


for _name, _f in _REDUCERS.items():
    _reduce_op(_name, _f)


@register("norm")
def _norm(x, ord=2, axis=None, keepdims=False, out_dtype=None):
    if isinstance(axis, (list, tuple)) and len(axis) == 1:
        axis = axis[0]
    dim = tuple(range(x.ndim)) if axis is None else axis
    if ord == 1:
        out = torch.abs(x).sum(dim=dim, keepdim=keepdims)
    elif ord == 2:
        out = torch.sqrt(torch.square(x).sum(dim=dim, keepdim=keepdims))
    else:
        raise ValueError("norm only supports ord=1 or ord=2, got %r" % (ord,))
    if axis is None and not keepdims:
        out = out.reshape(1)  # the reference's full-reduce norm is (1,)
    return out


@register("_square_sum")
def _square_sum(x, axis=None, keepdims=False):
    ax = _axes(axis)
    if ax is None:
        ax = tuple(range(x.ndim))
    if not ax:
        return torch.square(x)
    return torch.square(x).sum(dim=ax, keepdim=keepdims)


def _arg(f, x, axis, keepdims):
    if axis is None:
        res = f(x.reshape(-1))
        res = res.reshape((1,) * x.ndim) if keepdims else res
    else:
        res = f(x, dim=axis, keepdim=keepdims)
    return res.float()  # the reference returns real_t indices


@register("argmax", differentiable=False)
def _argmax(x, axis=None, keepdims=False):
    return _arg(torch.argmax, x, axis, keepdims)


@register("argmin", differentiable=False)
def _argmin(x, axis=None, keepdims=False):
    return _arg(torch.argmin, x, axis, keepdims)


@register("argmax_channel", differentiable=False)
def _argmax_channel(x):
    return torch.argmax(x, dim=1).float()


@register("pick")
def _pick(x, index, axis=-1, keepdims=False, mode="clip"):
    """``x`` at ``index`` along ``axis``; the index arrives as a float
    array (gluon's labels) and is truncated to an integer, then clipped
    into range or wrapped (``mode``), as the reference does."""
    ax = axis % x.ndim
    idx = index.to(torch.int64)
    if mode == "wrap":
        idx = torch.remainder(idx, x.shape[ax])
    else:
        idx = idx.clamp(0, x.shape[ax] - 1)
    picked = torch.gather(x, ax, idx.unsqueeze(ax))
    return picked if keepdims else picked.squeeze(ax)
