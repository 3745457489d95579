"""Lookup and storage ops of the PyTorch port (counterpart of
``Embedding`` in ``mxtpu/ops/indexing.py`` and of the dense graph forms
of ``cast_storage`` and ``_sparse_retain`` in ``mxtpu/ops/vision.py``).

``Embedding`` clips out-of-range ids into ``[0, input_dim)`` as the JAX
package's ``take`` does; ``F.embedding`` raises on them instead, and on
the card as a device-side assert that poisons the CUDA context.  Float
ids (the reference's data arrays are float32) are truncated toward
zero, as ``astype(int32)`` truncates.  As an op (traced into a graph)
its weight gradient is dense, whatever ``sparse_grad`` says, as in the
JAX package; recorded imperatively with ``sparse_grad=True``
(``nd.Embedding``, a gluon ``Embedding`` not hybridized) it runs
:func:`embedding_sparse_grad`, whose gradient with respect to a leaf
weight is a sparse COO tensor over the looked-up ids.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .registry import register


def _ids(data, weight):
    return data.long().clamp(0, weight.shape[0] - 1)


@register("Embedding")
def _embedding(data, weight, input_dim=0, output_dim=0, dtype="float32",
               sparse_grad=False):
    return F.embedding(_ids(data, weight), weight)


def embedding_sparse_grad(data, weight):
    """The lookup, with a sparse COO (uncoalesced) weight gradient when
    ``weight`` is a leaf; dense when it was computed, since the ops
    upstream take dense gradients (the JAX package densifies there too)."""
    return F.embedding(_ids(data, weight), weight, sparse=weight.is_leaf)


@register("cast_storage")
def _cast_storage(data, stype="default"):
    """In a graph every array is dense; the storage type lives on the
    imperative arrays (``ndarray.sparse.cast_storage``)."""
    return data


@register("_sparse_retain")
def _sparse_retain(data, indices):
    """Rows of ``data`` not named in ``indices`` become zeros."""
    rows = torch.arange(data.shape[0], device=data.device)
    keep = torch.isin(rows, indices.long())
    return torch.where(keep.reshape((-1,) + (1,) * (data.dim() - 1)),
                       data, torch.zeros((), dtype=data.dtype,
                                         device=data.device))
