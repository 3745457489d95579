"""Gluon utilities of the PyTorch port (counterpart of
``mxtpu/gluon/utils.py``): ``split_data``, ``split_and_load`` and
``clip_global_norm``.  ``download`` is not ported: the port reads
files from disk."""
from __future__ import annotations

import math
import warnings
from typing import List

import torch

from ..base import MXNetError
from ..ndarray.ndarray import NDArray, array as nd_array

__all__ = ["split_data", "split_and_load", "clip_global_norm"]


def split_data(data: NDArray, num_slice: int, batch_axis=0,
               even_split=True) -> List[NDArray]:
    """``num_slice`` pieces of ``data`` along ``batch_axis`` (views)."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise MXNetError(
            "data with shape %s cannot be evenly split into %d slices; "
            "set even_split=False" % (data.shape, num_slice))
    step = size // num_slice if even_split else \
        int(math.ceil(size / num_slice))
    return [NDArray(data._data.narrow(batch_axis, begin,
                                      min(size, begin + step) - begin))
            for begin in range(0, size, step)][:num_slice]


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """Split ``data`` along ``batch_axis`` and put one piece on each
    device of ``ctx_list``."""
    if not isinstance(data, NDArray):
        data = nd_array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(ctx) for s, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays: List[NDArray], max_norm: float,
                     check_isfinite=True):
    """Scale ``arrays`` in place so that their joint L2 norm is at most
    ``max_norm``; returns the norm before scaling (a float)."""
    with torch.no_grad():
        total = math.sqrt(sum(float((a._data.float() ** 2).sum())
                              for a in arrays))
        if check_isfinite and not math.isfinite(total):
            warnings.warn("nan or inf found in gradients; clip_global_norm "
                          "did not rescale")
            return total
        scale = max_norm / (total + 1e-8)
        if scale < 1.0:
            for a in arrays:
                a._data.mul_(scale)
    return total
