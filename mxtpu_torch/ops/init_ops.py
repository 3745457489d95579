"""Initialization ops of the PyTorch port (counterpart of ``_zeros``,
``_ones`` and ``_full`` in ``mxtpu/ops/init_ops.py``).  They take the
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
