"""Shape and product ops of the PyTorch port (counterpart of
``mxtpu/ops/matrix.py``).

``Reshape`` keeps the reference's special codes (0 copy, -1 infer, -2
copy the rest, -3 merge two, -4 split one).  The slices, ``expand_dims``,
``squeeze``, ``moveaxis``, ``reverse`` and the transposes are torch views
or expansions, which the imperative layer copies (no two arrays share
memory, as in the JAX package); a slice with a negative step picks its
elements with an index.  ``clip`` is ``minimum(maximum(x, lo), hi)``,
never ``torch.clamp``: at a bound the gradient is 0.5, as the
reference's is.  ``Pad``'s edge and reflect modes gather with numpy's
padding of the indices, so every axis and width pads as ``jnp.pad``
does.  The products (``dot``, ``batch_dot``, ``einsum``,
``_onnx_MatMul``) run on cuBLAS on the card, with TF32 off for
float32 (``fp32_library``).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

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


@register("batch_dot", fp32_library=True)
def _batch_dot(lhs, rhs, transpose_a=False, transpose_b=False,
               forward_stype=None):
    a = lhs.transpose(-1, -2) if transpose_a else lhs
    b = rhs.transpose(-1, -2) if transpose_b else rhs
    return torch.matmul(a, b)


@register("einsum", fp32_library=True)
def _einsum(*args, subscripts=None, num_args=None):
    """General contraction, ``subscripts`` as ``"bij,bjk->bik"``."""
    if not subscripts:
        raise ValueError("einsum requires the `subscripts` attr")
    return torch.einsum(subscripts, *args)


@register("_onnx_MatMul", fp32_library=True)
def _onnx_matmul(a, b):
    """numpy's matmul (ONNX MatMul): batched with broadcasting past 2-D,
    where ``dot`` contracts the last axis with the first."""
    return torch.matmul(a, b)


@register("khatri_rao")
def _khatri_rao(*args, num_args=None):
    out = args[0]
    for m in args[1:]:
        k1, r = out.shape
        out = (out[:, None, :] * m[None, :, :]).reshape(k1 * m.shape[0], r)
    return out


# ---------------------------------------------------------------------------
# axes
# ---------------------------------------------------------------------------

@register("expand_dims")
def _expand_dims(x, axis=0):
    return x.unsqueeze(axis)


@register("squeeze")
def _squeeze(x, axis=None):
    if axis is None:
        return x.squeeze()
    return x.squeeze(axis if isinstance(axis, (tuple, list)) else (axis,))


@register("moveaxis")
def _moveaxis(x, source=0, destination=0):
    return torch.movedim(x, source, destination)


@register("reverse", aliases=("flip",))
def _reverse(x, axis=()):
    return torch.flip(x, axis if isinstance(axis, (tuple, list))
                      else (axis,))


@register("repeat")
def _repeat(x, repeats=1, axis=None):
    return torch.repeat_interleave(x, repeats, dim=axis)


@register("tile")
def _tile(x, reps=()):
    return torch.tile(x, tuple(reps))


@register("depth_to_space")
def _depth_to_space(x, block_size=1):
    n, c, h, w = x.shape
    b = block_size
    y = x.reshape(n, b, b, c // (b * b), h, w).permute(0, 3, 4, 1, 5, 2)
    return y.reshape(n, c // (b * b), h * b, w * b)


@register("space_to_depth")
def _space_to_depth(x, block_size=1):
    n, c, h, w = x.shape
    b = block_size
    y = x.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return y.reshape(n, c * b * b, h // b, w // b)


@register("diag")
def _diag(x, k=0, axis1=0, axis2=1):
    if x.dim() == 1:
        return torch.diag(x, k)
    return torch.diagonal(x, offset=k, dim1=axis1, dim2=axis2)


# ---------------------------------------------------------------------------
# slices
# ---------------------------------------------------------------------------

def _slices(x, begin, end, step):
    step = step or (None,) * x.dim()
    return [slice(begin[i] if i < len(begin) else None,
                  end[i] if i < len(end) else None,
                  step[i] if i < len(step) else None)
            for i in range(x.dim())]


def _reversed_step(slices):
    return any(s.step is not None and s.step < 0 for s in slices)


def _index_of(sl, n, device):
    return torch.arange(n, device=device)[sl] if sl.step is None \
        or sl.step > 0 else torch.tensor(range(*sl.indices(n)),
                                         dtype=torch.int64, device=device)


def _take_slices(x, slices):
    """``x[slices]``, where a slice may step backward (torch has no
    negative strides: those axes are gathered by index)."""
    if not _reversed_step(slices):
        return x[tuple(slices)]
    for a, sl in enumerate(slices):
        if sl.step is not None and sl.step < 0:
            x = x.index_select(a, _index_of(sl, x.shape[a], x.device))
        else:
            x = x[(slice(None),) * a + (sl,)]
    return x


def _assign_slices(x, slices, value):
    """A copy of ``x`` with ``value`` written at ``slices``."""
    out = x.clone()
    if not _reversed_step(slices):
        out[tuple(slices)] = value
        return out
    grids = []
    for a, sl in enumerate(slices):
        shape = [1] * x.dim()
        shape[a] = -1
        grids.append(_index_of(sl, x.shape[a], x.device).reshape(shape))
    out[tuple(grids)] = value
    return out


@register("slice")
def _slice(x, begin=(), end=(), step=None):
    return _take_slices(x, _slices(x, begin, end, step))


@register("slice_axis")
def _slice_axis(x, axis=0, begin=0, end=None):
    ax = axis % x.dim()
    return x[(slice(None),) * ax + (slice(begin, end),)]


@register("slice_like")
def _slice_like(x, like, axes=()):
    sl = [slice(None)] * x.dim()
    for a in (axes if axes else range(min(x.dim(), like.dim()))):
        sl[a % x.dim()] = slice(0, like.shape[a % like.dim()])
    return x[tuple(sl)]


@register("_slice_assign")
def _slice_assign(x, value, begin=(), end=(), step=None):
    return _assign_slices(x, _slices(x, begin, end, step), value)


@register("_slice_assign_scalar")
def _slice_assign_scalar(x, scalar=0.0, begin=(), end=(), step=None):
    return _assign_slices(x, _slices(x, begin, end, step), scalar)


@register("Crop", aliases=("crop",))
def _crop(x, *like, offset=(0, 0), h_w=(0, 0), num_args=1,
          center_crop=False):
    h, w = h_w if not like else like[0].shape[2:4]
    if center_crop:
        oh, ow = (x.shape[2] - h) // 2, (x.shape[3] - w) // 2
    else:
        oh, ow = offset
    return x[:, :, oh:oh + h, ow:ow + w]


# ---------------------------------------------------------------------------
# values
# ---------------------------------------------------------------------------

def clip_tensor(x, lo, hi):
    """``minimum(maximum(x, lo), hi)``: the gradient at a bound is 0.5,
    as the reference's ``jnp.clip`` gives (``torch.clamp`` gives 1)."""
    def bound(v):
        return torch.full((), v, dtype=x.dtype, device=x.device)

    return torch.minimum(torch.maximum(x, bound(lo)), bound(hi))


@register("clip")
def _clip(x, a_min=0.0, a_max=0.0):
    return clip_tensor(x, a_min, a_max)


@register("Pad", aliases=("pad",))
def _pad(x, mode="constant", pad_width=(), constant_value=0.0):
    pw = [(int(pad_width[2 * i]), int(pad_width[2 * i + 1]))
          for i in range(len(pad_width) // 2)]
    if mode == "constant":
        flat = [p for lo_hi in reversed(pw) for p in lo_hi]
        return F.pad(x, flat, mode="constant", value=constant_value)
    if mode not in ("edge", "reflect"):
        raise MXNetError("unsupported pad mode %r" % mode)
    for a, (lo, hi) in enumerate(pw):
        if lo or hi:
            idx = np.pad(np.arange(x.shape[a]), (lo, hi),
                         mode=mode)
            x = x.index_select(a, torch.as_tensor(idx, device=x.device))
    return x
