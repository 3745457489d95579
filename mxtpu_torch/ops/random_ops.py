"""Random samplers of the PyTorch port (counterpart of
``_random_uniform`` and ``_random_normal`` in
``mxtpu/ops/random_ops.py``).  Each takes a ``torch.Generator`` of the
device it draws on (``mxtpu_torch.random``) where the JAX package's
take a PRNG key, so the two packages never draw the same numbers."""
from __future__ import annotations

import torch

from ..base import torch_dtype
from .registry import register


@register("_random_uniform", needs_rng=True, differentiable=False,
          aliases=("uniform", "random_uniform"))
def _random_uniform(gen, low=0.0, high=1.0, shape=(), dtype="float32",
                    device=None):
    out = torch.empty(tuple(shape), dtype=torch_dtype(dtype), device=device)
    return out.uniform_(low, high, generator=gen)


@register("_random_normal", needs_rng=True, differentiable=False,
          aliases=("normal", "random_normal"))
def _random_normal(gen, loc=0.0, scale=1.0, shape=(), dtype="float32",
                   device=None):
    out = torch.empty(tuple(shape), dtype=torch_dtype(dtype), device=device)
    return out.normal_(loc, scale, generator=gen)
