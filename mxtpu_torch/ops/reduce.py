"""Reductions of the PyTorch port (counterpart of ``sum``, ``mean``,
``argmax`` and ``pick`` in ``mxtpu/ops/reduce.py``)."""
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


def _reduce_op(name, f):
    def op(x, axis=None, keepdims=False, exclude=False):
        ax = _axes(axis, exclude, x.ndim)
        if ax is None:
            ax = tuple(range(x.ndim))
        return f(x, ax, keepdims)

    register(name)(op)


_reduce_op("sum", lambda x, ax, kd: x.sum(dim=ax, keepdim=kd))
_reduce_op("mean", lambda x, ax, kd: x.mean(dim=ax, keepdim=kd))


@register("argmax", differentiable=False)
def _argmax(x, axis=None, keepdims=False):
    if axis is None:
        res = x.reshape(-1).argmax()
        res = res.reshape((1,) * x.ndim) if keepdims else res
    else:
        res = x.argmax(dim=axis, keepdim=keepdims)
    return res.float()  # the reference returns real_t indices


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
