"""Indexing, ordering and storage ops of the PyTorch port (counterpart
of ``mxtpu/ops/indexing.py``, and of
the dense graph forms of ``cast_storage`` and ``_sparse_retain`` in
``mxtpu/ops/vision.py``).

``sort`` and ``argsort`` are a stable ascending sort; descending is that
result flipped, so tied elements come out in reverse index order, as
in the reference.  ``topk`` is built on the same stable sort, so among
ties the lowest index comes first, as ``lax.top_k`` orders them
(``torch.topk`` leaves the order of ties open, and the card's differs
from the CPU's).  Index results are float32 unless ``dtype`` says
otherwise; float indices are truncated toward zero.  ``scatter_nd``
sums repeated indices; ``_scatter_set_nd`` with repeated indices keeps
one of the values, which the reference leaves open too.

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
``_contrib_SparseEmbedding`` is the same lookup whose imperative
recorded gradient is always that sparse one, whatever its attrs say.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..base import torch_dtype
from .registry import register


def _ids(data, weight):
    return data.long().clamp(0, weight.shape[0] - 1)


@register("Embedding")
def _embedding(data, weight, input_dim=0, output_dim=0, dtype="float32",
               sparse_grad=False):
    return F.embedding(_ids(data, weight), weight)


@register("_contrib_SparseEmbedding")
def _sparse_embedding(data, weight, input_dim=0, output_dim=0,
                      dtype="float32", deterministic=False):
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


@register("take")
def _take(a, indices, axis=0, mode="clip"):
    idx = indices.long()
    n = a.shape[axis]
    if mode == "wrap":
        idx = torch.remainder(idx, n)
    elif mode == "clip":
        idx = idx.clamp(0, n - 1)
    out = a.index_select(axis, idx.reshape(-1))
    ax = axis % a.dim()
    return out.reshape(a.shape[:ax] + idx.shape + a.shape[ax + 1:])


@register("batch_take")
def _batch_take(a, indices):
    idx = indices.long().clamp(0, a.shape[1] - 1)
    return torch.gather(a, 1, idx.unsqueeze(1)).squeeze(1)


def _nd_index(indices):
    idx = indices.long()
    return tuple(idx[i] for i in range(idx.shape[0]))


@register("gather_nd")
def _gather_nd(data, indices):
    return data[_nd_index(indices)]


@register("scatter_nd")
def _scatter_nd(data, indices, shape=()):
    out = torch.zeros(tuple(shape), dtype=data.dtype, device=data.device)
    return out.index_put(_nd_index(indices), data, accumulate=True)


@register("_scatter_set_nd")
def _scatter_set_nd(lhs, rhs, indices, shape=()):
    return lhs.index_put(_nd_index(indices), rhs)


def _sorted(x, axis, is_ascend):
    """(values, indices) of the stable ascending sort along ``axis``
    (the flattened array when None), flipped when descending."""
    if axis is None:
        x, axis = x.reshape(-1), 0
    vals, idx = torch.sort(x, dim=axis, stable=True)
    if not is_ascend:
        vals, idx = vals.flip(axis), idx.flip(axis)
    return vals, idx


@register("sort", differentiable=False)
def _sort(x, axis=-1, is_ascend=True):
    return _sorted(x, axis, is_ascend)[0]


@register("argsort", differentiable=False)
def _argsort(x, axis=-1, is_ascend=True, dtype="float32"):
    return _sorted(x, axis, is_ascend)[1].to(torch_dtype(dtype))


@register("topk", differentiable=False,
          num_outputs=lambda attrs: 2 if attrs.get("ret_typ") == "both"
          else 1)
def _topk(x, axis=-1, k=1, ret_typ="indices", is_ascend=False,
          dtype="float32"):
    ax = x.dim() - 1 if axis is None else axis % x.dim()
    # the k smallest (or largest) with the lowest index first among ties
    idx = torch.sort(x, dim=ax, stable=True,
                     descending=not is_ascend)[1].narrow(ax, 0, k)
    if ret_typ == "indices":
        return idx.to(torch_dtype(dtype))
    vals = torch.gather(x, ax, idx)
    if ret_typ == "value":
        return vals
    if ret_typ == "both":
        return vals, idx.to(torch_dtype(dtype))
    if ret_typ == "mask":
        return torch.zeros_like(x).scatter(ax, idx, 1)
    raise ValueError("unknown ret_typ %r" % ret_typ)


def _strides(shape):
    return np.concatenate([np.cumprod(np.asarray(shape[::-1]))[::-1][1:],
                           [1]]).astype(np.int64)


@register("_ravel_multi_index", differentiable=False)
def _ravel_multi_index(data, shape=()):
    idx = data.long()
    out = sum(idx[i] * int(s) for i, s in enumerate(_strides(shape)))
    return out.float()


@register("_unravel_index", differentiable=False)
def _unravel_index(data, shape=()):
    idx = data.long()
    return torch.stack([(idx // int(s)) % int(n) for s, n in
                        zip(_strides(shape), shape)]).float()


@register("_histogram", differentiable=False, num_outputs=2)
def _histogram(data, bin_cnt=10, range=None):
    """``bin_cnt`` equal bins over ``range`` (the data's extent when
    None), the last bin closed, as ``jnp.histogram``: (counts, edges),
    float32."""
    x = data.reshape(-1)
    lo, hi = range if range is not None else (float(x.min()),
                                              float(x.max()))
    dtype = x.dtype if x.dtype.is_floating_point else torch.float32
    edges = torch.linspace(lo, hi, int(bin_cnt) + 1, dtype=dtype,
                           device=x.device)
    at = torch.searchsorted(edges, x.to(dtype), right=True)
    at = torch.where(x == edges[-1], len(edges) - 1, at)
    counts = torch.bincount(at, minlength=len(edges) + 1)[1:len(edges)]
    return counts.float(), edges.float()


@register("_contrib_boolean_mask")
def _boolean_mask(data, index, axis=0):
    """The rows ``index`` does not select become zeros: the shape stays,
    as in the JAX package (MXNet compacts the array)."""
    shape = [1] * data.dim()
    shape[axis] = data.shape[axis]
    return data * (index != 0).reshape(shape).to(data.dtype)


@register("_contrib_index_copy")
def _index_copy(old, idx, new):
    return old.index_copy(0, idx.long(), new)


@register("_contrib_getnnz", differentiable=False)
def _getnnz(data, axis=None):
    nz = (data != 0).long()
    return nz.sum() if axis is None else nz.sum(dim=axis)


@register("_contrib_count_sketch")
def _count_sketch(data, h, s, out_dim=0, processing_batch_size=32):
    d = data.shape[1]
    hh = h.reshape(-1).long()[:d]
    out = torch.zeros((data.shape[0], out_dim), dtype=data.dtype,
                      device=data.device)
    return out.index_add(1, hh, data * s.reshape(-1)[:d].unsqueeze(0))
