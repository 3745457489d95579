"""Shape ops of the PyTorch port.

Counterpart of the part of ``mxtpu/ops/matrix.py`` that the ResNet graph,
NDArray, gluon's losses and the recurrent paths use: ``Reshape`` with
the reference's special codes (0 copy, -1 infer, -2 copy the rest, -3
merge two, -4 split one), ``reshape_like``, ``Flatten``, ``transpose``,
``where``, ``SwapAxis``, ``stack``, ``Concat``, ``_rnn_param_concat``
(the flat parameter vector of the ``RNN`` op) and ``SliceChannel``;
``one_hot`` and ``dot`` (the dense product, on cuBLAS on the card, with
TF32 off for float32: ``fp32_library``).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..base import MXNetError, torch_dtype
from .registry import register


def _mx_reshape_target(in_shape: Tuple[int, ...], spec, reverse=False):
    spec = tuple(int(s) for s in spec)
    if reverse:
        in_shape = tuple(reversed(in_shape))
        spec = tuple(reversed(spec))
    out = []
    src = 0
    i = 0
    infer_at = None
    while i < len(spec):
        s = spec[i]
        if s > 0:
            out.append(s)
            src += 1
        elif s == 0:
            out.append(in_shape[src])
            src += 1
        elif s == -1:
            if infer_at is not None:
                raise MXNetError("reshape can infer at most one dimension")
            infer_at = len(out)
            out.append(-1)
            src += 1
        elif s == -2:
            out.extend(in_shape[src:])
            src = len(in_shape)
        elif s == -3:
            out.append(in_shape[src] * in_shape[src + 1])
            src += 2
        elif s == -4:
            d1, d2 = spec[i + 1], spec[i + 2]
            cur = in_shape[src]
            if d1 == -1:
                d1 = cur // d2
            if d2 == -1:
                d2 = cur // d1
            out.extend([d1, d2])
            src += 1
            i += 2
        else:
            raise MXNetError("invalid reshape code %d" % s)
        i += 1
    total = int(np.prod(in_shape)) if in_shape else 1
    if infer_at is not None:
        rest = int(np.prod([d for d in out if d != -1])) or 1
        out[infer_at] = total // rest
    if reverse:
        out = list(reversed(out))
    return tuple(out)


@register("Reshape", aliases=("reshape",))
def _reshape(x, shape=(), reverse=False):
    return x.reshape(_mx_reshape_target(tuple(x.shape), shape, reverse))


@register("reshape_like")
def _reshape_like(x, other):
    return x.reshape(other.shape)


@register("Flatten", aliases=("flatten",))
def _flatten(x):
    return x.reshape(x.shape[0], -1)


@register("transpose")
def _transpose(x, axes=None):
    if not axes:
        axes = tuple(reversed(range(x.ndim)))
    return x.permute(*axes)


@register("where")
def _where(cond, x, y):
    return torch.where(cond != 0, x, y)


@register("SwapAxis", aliases=("swapaxes", "SwapAxes"))
def _swapaxis(x, dim1=0, dim2=0):
    return x.transpose(dim1, dim2)


@register("stack")
def _stack(*args, axis=0, num_args=None):
    return torch.stack(args, dim=axis)


@register("Concat", aliases=("concat",))
def _concat(*args, dim=1, num_args=None):
    return torch.cat(args, dim=dim)


@register("_rnn_param_concat")
def _rnn_param_concat(*args, dim=0, num_args=None):
    return torch.cat([a.reshape(-1) for a in args])


@register("SliceChannel", aliases=("split",),
          num_outputs=lambda attrs: attrs.get("num_outputs", 1))
def _slice_channel(x, num_outputs=1, axis=1, squeeze_axis=False):
    if x.shape[axis] % num_outputs:
        raise MXNetError("SliceChannel: axis %d of size %d does not split "
                         "into %d" % (axis, x.shape[axis], num_outputs))
    parts = torch.chunk(x, num_outputs, dim=axis)
    if squeeze_axis:
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts)


@register("one_hot", differentiable=False)
def _one_hot(indices, depth=1, on_value=1.0, off_value=0.0,
             dtype="float32"):
    """Rows of ``depth`` classes; an id outside [0, depth) gives a row of
    ``off_value`` (a comparison, so no host check of the ids)."""
    classes = torch.arange(int(depth), device=indices.device)
    hot = (indices.long().unsqueeze(-1) == classes).to(torch_dtype(dtype))
    return hot * (on_value - off_value) + off_value


def _reverse_axes(x):
    return x.permute(*reversed(range(x.dim())))


@register("dot", fp32_library=True)
def _dot(lhs, rhs, transpose_a=False, transpose_b=False,
         forward_stype=None):
    """The last axis of ``lhs`` against the first of ``rhs`` (all axes
    reversed first where transposed)."""
    a = _reverse_axes(lhs) if transpose_a else lhs
    b = _reverse_axes(rhs) if transpose_b else rhs
    if a.dim() == 1 and b.dim() == 1:
        return torch.dot(a, b)
    return torch.tensordot(a, b, dims=([a.dim() - 1], [0]))
