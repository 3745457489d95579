"""Image ops of the PyTorch port (counterpart of ``mxtpu/ops/image.py``),
which gluon's vision transforms call: to_tensor, normalize, the flips,
resize, crop, and the OpenCV-style ``_cvimresize`` and
``_cvcopyMakeBorder``.

Images are HWC or NHWC: width is axis -2 and height axis -3.

* The random flips draw one Bernoulli for the whole input, not one per
  image, as the JAX package does, and select on the device
  (``torch.where``): no value is read on the host.
* ``_image_resize`` is the JAX package's ``jax.image.resize`` on HWC:
  bilinear with half-pixel centres, antialiased when it shrinks
  (``F.interpolate(antialias=True)``), or nearest with half-pixel
  centres (``nearest-exact``), computed in float32 and cast back to the
  input's dtype (truncated, as XLA's convert truncates).
* ``_cvcopyMakeBorder`` pads an HWC image with numpy's modes: type 0
  constant (one value, or one per channel), 1 ``edge``, 2
  ``symmetric``, 4 ``reflect``.  The border's source rows and columns
  are ``np.pad`` of their indices, so a pad wider than the image
  reflects again, as numpy does (``F.pad(mode="reflect")`` refuses a
  pad not smaller than the dimension, and torch has no ``symmetric``).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from .registry import register


@register("_image_to_tensor", aliases=("to_tensor",))
def _to_tensor(data):
    """HWC uint8 [0, 255] -> CHW float32 [0, 1] (batch-aware)."""
    x = data.to(torch.float32) / 255.0
    perm = (2, 0, 1) if x.dim() == 3 else (0, 3, 1, 2)
    return x.permute(perm).contiguous()


@register("_image_normalize", aliases=("image_normalize",))
def _normalize(data, mean=(0.0,), std=(1.0,)):
    shape = (-1, 1, 1) if data.dim() == 3 else (1, -1, 1, 1)
    mean = torch.as_tensor(np.asarray(mean, np.float32),
                           device=data.device).reshape(shape)
    std = torch.as_tensor(np.asarray(std, np.float32),
                          device=data.device).reshape(shape)
    return (data - mean) / std


@register("_image_flip_left_right", differentiable=False)
def _flip_lr(data):
    return torch.flip(data, dims=(-2,))


@register("_image_flip_top_bottom", differentiable=False)
def _flip_tb(data):
    return torch.flip(data, dims=(-3,))


def _random_flip(gen, data, axis):
    flip = torch.rand((), generator=gen, device=data.device) < 0.5
    return torch.where(flip, torch.flip(data, dims=(axis,)), data)


@register("_image_random_flip_left_right", needs_rng=True,
          differentiable=False)
def _random_flip_lr(gen, data):
    return _random_flip(gen, data, -2)


@register("_image_random_flip_top_bottom", needs_rng=True,
          differentiable=False)
def _random_flip_tb(gen, data):
    return _random_flip(gen, data, -3)


@register("_image_resize", aliases=("image_resize",), differentiable=False)
def _resize(data, size=(0, 0), keep_ratio=False, interp=1):
    if isinstance(size, int):
        size = (size, size)
    w, h = int(size[0]), int(size[1])
    x = data.to(torch.float32)
    x = (x.unsqueeze(0) if x.dim() == 3 else x).permute(0, 3, 1, 2)
    if interp == 0:
        y = F.interpolate(x, size=(h, w), mode="nearest-exact")
    else:
        y = F.interpolate(x, size=(h, w), mode="bilinear",
                          align_corners=False, antialias=True)
    y = y.permute(0, 2, 3, 1)
    if data.dim() == 3:
        y = y[0]
    return y.contiguous().to(data.dtype)


@register("_image_crop", differentiable=False)
def _crop_img(data, x=0, y=0, width=0, height=0):
    if data.dim() == 3:
        return data[y:y + height, x:x + width].contiguous()
    return data[:, y:y + height, x:x + width].contiguous()


@register("_cvimresize", differentiable=False)
def _cvimresize(data, w=0, h=0, interp=1):
    """OpenCV-style resize as an op (HWC uint8 or float): the
    ``_image_resize`` above."""
    return _resize(data, size=(int(w), int(h)), interp=interp)


_BORDER_MODES = {1: "edge", 2: "symmetric", 4: "reflect"}


@register("_cvcopyMakeBorder", differentiable=False)
def _cvcopy_make_border(data, top=0, bot=0, left=0, right=0, type=0,
                        value=0.0, values=()):
    """Border padding of an HWC image: type 0 = BORDER_CONSTANT, 1 =
    BORDER_REPLICATE, 2 = BORDER_REFLECT, 4 = BORDER_REFLECT_101
    (OpenCV's numbering); other types raise."""
    top, bot, left, right = int(top), int(bot), int(left), int(right)
    hh, ww = data.shape[0], data.shape[1]
    if type == 0:
        c = data.shape[-1]
        out = data.new_empty((hh + top + bot, ww + left + right)
                             + tuple(data.shape[2:]))
        if values:
            vals = list(values) + [values[-1]] * (c - len(values))
            out[...] = torch.as_tensor(np.asarray(vals[:c], np.float64)) \
                .to(device=data.device, dtype=data.dtype)
        else:
            out.fill_(value)
        out[top:top + hh, left:left + ww] = data
        return out
    if type not in _BORDER_MODES:
        raise MXNetError("_cvcopyMakeBorder: unsupported border type %r"
                         % (type,))
    mode = _BORDER_MODES[type]
    rows = np.pad(np.arange(hh), (top, bot), mode=mode)
    cols = np.pad(np.arange(ww), (left, right), mode=mode)
    return data.index_select(0, torch.as_tensor(rows, device=data.device)) \
        .index_select(1, torch.as_tensor(cols, device=data.device))
