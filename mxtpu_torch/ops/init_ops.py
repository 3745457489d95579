"""Initialization ops of the PyTorch port (counterpart of
``mxtpu/ops/init_ops.py``): ``_zeros``, ``_ones``, ``_full``,
``_arange`` (with ``repeat``), ``_eye`` (with the diagonal ``k``) and
``_identity_with_attr_like_rhs``.  Those without an input take the
``device`` to create on from their caller."""
from __future__ import annotations

import torch

from ..base import torch_dtype
from .registry import register


@register("_zeros", differentiable=False, aliases=("_zeros_without_dtype",))
def _zeros(shape=(), dtype="float32", device=None):
    return torch.zeros(tuple(shape), dtype=torch_dtype(dtype), device=device)


@register("_ones", differentiable=False)
def _ones(shape=(), dtype="float32", device=None):
    return torch.ones(tuple(shape), dtype=torch_dtype(dtype), device=device)


@register("_full", differentiable=False)
def _full(shape=(), value=0.0, dtype="float32", device=None):
    return torch.full(tuple(shape), value, dtype=torch_dtype(dtype),
                      device=device)


@register("_arange", differentiable=False)
def _arange(start=0.0, stop=None, step=1.0, repeat=1, dtype="float32",
            device=None):
    if stop is None:  # one bound: [0, start)
        start, stop = 0.0, start
    arr = torch.arange(start, stop, step, dtype=torch_dtype(dtype),
                       device=device)
    return arr.repeat_interleave(repeat) if repeat and repeat > 1 else arr


@register("_eye", differentiable=False)
def _eye(N=0, M=0, k=0, dtype="float32", device=None):
    n, m = int(N), int(M) if M else int(N)
    rows = torch.arange(n, device=device).unsqueeze(1)
    cols = torch.arange(m, device=device).unsqueeze(0)
    return (cols - rows == int(k)).to(torch_dtype(dtype))


@register("_identity_with_attr_like_rhs")
def _identity_like_rhs(lhs, rhs):
    return lhs
