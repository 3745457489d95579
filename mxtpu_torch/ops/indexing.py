"""Lookup ops of the PyTorch port (counterpart of ``Embedding`` in
``mxtpu/ops/indexing.py``).

``Embedding`` clips out-of-range ids into ``[0, input_dim)`` as the JAX
package's ``take`` does; ``F.embedding`` raises on them instead, and on
the card as a device-side assert that poisons the CUDA context.  Float
ids (the reference's data arrays are float32) are truncated toward
zero, as ``astype(int32)`` truncates.  The weight's gradient is dense;
the row-sparse gradient (``sparse_grad=True``) is not ported.
"""
from __future__ import annotations

import torch.nn.functional as F

from ..base import MXNetError
from .registry import register


@register("Embedding")
def _embedding(data, weight, input_dim=0, output_dim=0, dtype="float32",
               sparse_grad=False):
    if sparse_grad:
        raise MXNetError("Embedding(sparse_grad=True) needs row-sparse "
                         "gradients, which are not ported (ROADMAP A10c, "
                         "A14)")
    ids = data.long().clamp(0, weight.shape[0] - 1)
    return F.embedding(ids, weight)
