"""Sparse NDArrays of the PyTorch port: CSR and row-sparse.

Counterpart of ``mxtpu/ndarray/sparse.py``.  A sparse array's
unspecified entries are zeros; its parts are plain tensors on one
device:

* row_sparse: ``data`` [k, ...] holds the stored rows, ``indices`` [k]
  their row ids, sorted, unique and in range (as MXNet's
  ``RowSparseNDArray``; the JAX package pads its gradients' ids with the
  out-of-range id ``shape[0]`` for XLA's static shapes, which a CUDA
  index op would take as a device-side assert);
* csr: ``data`` [nnz], ``indices`` [nnz] (column ids), ``indptr``
  [m + 1], with a host copy of ``indptr``, so that a product never
  copies it back from the card.

Index arrays are int64 (the JAX package keeps int32): torch's index ops
take int64.  Every kernel is a PyTorch op, as the JAX package leaves
its kernels to XLA: ``dot(csr, W)`` gathers the rows of ``W`` that the
batch names, scales them by the values and sums them by row
(``index_select``, ``index_add_``); under ``autograd.record()`` it
tapes a ``torch.autograd.Function`` whose gradient with respect to a
leaf ``W`` is a sparse COO tensor over the batch's columns, which
``autograd.backward`` coalesces into the leaf's ``RowSparseNDArray``
gradient.  Ops without a sparse form run on the densified array (the
storage fallback of ``imperative_invoke``).

Host synchronisations, as in the JAX package's host round trips:
``cast_storage`` from dense (``nonzero``), ``retain``,
``retain_rows_into`` and ``add`` (``torch.unique``, whose size is known
only on the host), and a CSR built from device tensors (its ``indptr``
read back once).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..base import MXNetError, torch_dtype
from ..context import resolve
from .ndarray import NDArray, array as _dense_array, imperative_invoke

__all__ = ["BaseSparseNDArray", "CSRNDArray", "RowSparseNDArray",
           "csr_matrix", "row_sparse_array", "cast_storage", "zeros",
           "empty", "array", "dot", "retain", "retain_rows_into",
           "set_rows_into", "add", "elemwise_add"]


# ---------------------------------------------------------------------------
# Classes
# ---------------------------------------------------------------------------

class BaseSparseNDArray(NDArray):
    """What CSR and row-sparse arrays share: ``_data`` holds the packed
    values, ``_aux`` the index tensors, ``_shape`` the dense shape."""

    __slots__ = ("_shape", "_aux")

    def __init__(self, data: torch.Tensor, aux, shape):
        super().__init__(data)
        self._aux = tuple(aux)
        self._shape = tuple(int(s) for s in shape)

    @property
    def shape(self) -> Tuple[int, ...]:
        return self._shape

    @property
    def size(self) -> int:
        return int(np.prod(self._shape, dtype=np.int64))

    @property
    def ndim(self) -> int:
        return len(self._shape)

    @property
    def data(self) -> NDArray:
        return NDArray(self._data)

    def __repr__(self):
        return "\n<%s %s @%s>" % (type(self).__name__,
                                  "x".join(map(str, self._shape)), self.ctx)

    def asnumpy(self) -> np.ndarray:
        return self.todense().asnumpy()

    def astype(self, dtype, copy: bool = True):
        raise MXNetError("astype on sparse: tostype('default') first")

    def todense(self) -> NDArray:
        return cast_storage(self, "default")

    def tostype(self, stype: str):
        return cast_storage(self, stype)

    def _parts(self):
        return (self._data,) + self._aux

    def _like(self, parts, shape):
        return type(self)(parts[0], parts[1:], shape)

    def copy(self):
        return self._like([t.clone() for t in self._parts()], self._shape)

    def _assign(self, src: "BaseSparseNDArray"):
        """Make this array hold ``src``'s parts (same storage type)."""
        self._data, self._aux, self._shape = src._data, src._aux, src._shape

    def copyto(self, other):
        if isinstance(other, BaseSparseNDArray):
            src = self if self.stype == other.stype \
                else cast_storage(self, other.stype)
            if src.ctx != other.ctx:
                src = src.as_in_context(other.ctx)
            other._assign(src.copy() if src is self else src)
            return other
        if isinstance(other, NDArray):
            return self.todense().copyto(other)
        return self._like([t.to(resolve(other), copy=True)
                           for t in self._parts()], self._shape)

    def detach(self):
        return self._like([t.detach() for t in self._parts()], self._shape)

    def attach_grad(self, grad_req: str = "write", stype=None):
        raise MXNetError("attach_grad on a %s array: the port marks dense "
                         "arrays only" % self.stype)

    def __getitem__(self, key):
        raise MXNetError("indexing is not supported on %s" % self.stype)

    def __setitem__(self, key, value):
        raise MXNetError("assignment is not supported on %s" % self.stype)


class CSRNDArray(BaseSparseNDArray):
    """A 2-D compressed sparse row array; ``_aux`` is (indptr, indices)
    and ``_indptr_host`` the host copy of indptr."""

    __slots__ = ("_indptr_host", "_rows")

    def __init__(self, data, aux, shape, indptr_host=None):
        super().__init__(data, aux, shape)
        if indptr_host is None:
            indptr_host = aux[0].cpu().numpy()
        self._indptr_host = np.asarray(indptr_host, np.int64)
        self._rows = None

    @property
    def stype(self) -> str:
        return "csr"

    @property
    def indices(self) -> NDArray:
        return NDArray(self._aux[1])

    @property
    def indptr(self) -> NDArray:
        return NDArray(self._aux[0])

    @property
    def nnz(self) -> int:
        return int(self._data.shape[0])

    def _like(self, parts, shape):
        return CSRNDArray(parts[0], parts[1:], shape, self._indptr_host)

    def _assign(self, src):
        super()._assign(src)
        self._indptr_host, self._rows = src._indptr_host, src._rows

    def row_ids(self) -> torch.Tensor:
        """The row of each stored value, [nnz] int64 on the array's
        device, made there from indptr (no host round trip)."""
        if self._rows is None:
            indptr = self._aux[0]
            self._rows = torch.repeat_interleave(
                torch.arange(self._shape[0], device=indptr.device),
                indptr[1:] - indptr[:-1], output_size=self.nnz)
        return self._rows

    def dot(self, other, transpose_a=False, **kw):
        return dot(self, other, transpose_a=transpose_a)


class RowSparseNDArray(BaseSparseNDArray):
    """An array sparse in its first dimension; ``_aux`` is (indices,),
    the stored rows' ids, sorted, unique and in range."""

    @property
    def stype(self) -> str:
        return "row_sparse"

    @property
    def indices(self) -> NDArray:
        return NDArray(self._aux[0])

    def retain(self, row_ids) -> "RowSparseNDArray":
        return retain(self, row_ids)


# ---------------------------------------------------------------------------
# Constructors
# ---------------------------------------------------------------------------

def _device_of(ctx, *sources):
    if ctx is not None:
        return resolve(ctx)
    for s in sources:
        if isinstance(s, NDArray):
            return s._data.device
        if isinstance(s, torch.Tensor):
            return s.device
    return resolve(None)


def _values(x, device, dtype=None) -> torch.Tensor:
    if isinstance(x, NDArray):
        t = x._data.detach()
    elif isinstance(x, torch.Tensor):
        t = x.detach()
    else:
        a = np.asarray(x)
        if dtype is None and a.dtype == np.float64:
            a = a.astype(np.float32)
        t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=device, dtype=torch_dtype(dtype) if dtype else None)


def _host_index(x):
    """A host int64 copy of an index source, or None when it lies on a
    card (it is then not read back)."""
    if isinstance(x, NDArray):
        x = x._data
    if isinstance(x, torch.Tensor):
        return x.long().numpy() if x.device.type == "cpu" else None
    return np.asarray(x).astype(np.int64)


def _index_tensor(x, device) -> torch.Tensor:
    if isinstance(x, NDArray):
        x = x._data
    if isinstance(x, torch.Tensor):
        return x.detach().to(device=device, dtype=torch.int64)
    return torch.from_numpy(np.asarray(x).astype(np.int64)).to(device)


def _check_range(host_ids, bound, what):
    if host_ids is not None and host_ids.size and (
            host_ids.min() < 0 or host_ids.max() >= bound):
        raise MXNetError("%s out of range [0, %d): %d..%d"
                         % (what, bound, host_ids.min(), host_ids.max()))


def csr_matrix(arg1, shape=None, ctx=None, dtype=None) -> CSRNDArray:
    """``csr_matrix((data, indices, indptr), shape=(m, n))``, or from a
    dense NDArray, a numpy array or a scipy sparse matrix, on ``ctx``
    (default: the source's device, else the card).  Host index sources
    are checked to lie in range."""
    if isinstance(arg1, tuple) and len(arg1) == 3:
        data, indices, indptr = arg1
        if shape is None:
            raise MXNetError("shape required for (data, indices, indptr)")
        m, n = (int(s) for s in shape)
        device = _device_of(ctx, data, indices, indptr)
        host_ptr = _host_index(indptr)
        if host_ptr is None:  # read back once, here
            host_ptr = _index_tensor(indptr, "cpu").numpy()
        vals = _values(data, device, dtype)
        cols = _index_tensor(indices, device)
        if len(host_ptr) != m + 1 or host_ptr[0] != 0 \
                or np.any(np.diff(host_ptr) < 0) \
                or host_ptr[-1] != vals.shape[0] \
                or cols.shape[0] != vals.shape[0]:
            raise MXNetError("inconsistent CSR parts: indptr %d entries "
                             "(ending at %d) for %d rows, %d values, %d "
                             "column ids" % (len(host_ptr), host_ptr[-1], m,
                                             vals.shape[0], cols.shape[0]))
        _check_range(_host_index(indices), n, "column ids")
        ptr = torch.from_numpy(host_ptr).to(device)
        return CSRNDArray(vals, (ptr, cols), (m, n), host_ptr)
    if hasattr(arg1, "tocsr"):  # scipy sparse
        s = arg1.tocsr()
        return csr_matrix((s.data, s.indices, s.indptr), shape=s.shape,
                          ctx=ctx, dtype=dtype)
    dense = arg1 if isinstance(arg1, NDArray) else _dense_array(
        arg1, ctx=ctx, dtype=dtype)
    return cast_storage(dense, "csr")


def row_sparse_array(arg1, shape=None, ctx=None, dtype=None) \
        -> RowSparseNDArray:
    """``row_sparse_array((data, indices), shape=...)`` or from a dense
    source.  Host row ids are checked to lie in range and to be unique,
    and sorted with their rows when they are not."""
    if isinstance(arg1, tuple) and len(arg1) == 2 \
            and not np.isscalar(arg1[0]):
        data, indices = arg1
        if shape is None:
            raise MXNetError("shape required for (data, indices)")
        shape = tuple(int(s) for s in shape)
        device = _device_of(ctx, data, indices)
        vals = _values(data, device, dtype)
        rows = _index_tensor(indices, device)
        host = _host_index(indices)
        _check_range(host, shape[0], "row ids")
        if host is not None and np.any(np.diff(host) <= 0):
            order = np.argsort(host, kind="stable")
            if np.any(np.diff(host[order]) == 0):
                raise MXNetError("duplicate row ids in row_sparse_array")
            perm = torch.from_numpy(order).to(device)
            vals, rows = vals.index_select(0, perm), rows.index_select(0, perm)
        if vals.shape[0] != rows.shape[0] or \
                tuple(vals.shape[1:]) != shape[1:]:
            raise MXNetError("row_sparse parts %s and %d ids do not fit %s"
                             % (tuple(vals.shape), rows.shape[0], shape))
        return RowSparseNDArray(vals, (rows,), shape)
    dense = arg1 if isinstance(arg1, NDArray) else _dense_array(
        arg1, ctx=ctx, dtype=dtype)
    return cast_storage(dense, "row_sparse")


def zeros(stype: str, shape, ctx=None, dtype=None):
    """An all-zero array of storage type ``stype`` on ``ctx`` (default:
    the card)."""
    shape = tuple(int(s) for s in shape)
    if stype == "default":
        from .ndarray import zeros as _dense_zeros

        return _dense_zeros(shape, ctx=ctx, dtype=dtype)
    device, dt = resolve(ctx), torch_dtype(dtype)
    empty_ids = torch.zeros((0,), dtype=torch.int64, device=device)
    if stype == "row_sparse":
        return RowSparseNDArray(torch.zeros((0,) + shape[1:], dtype=dt,
                                            device=device),
                                (empty_ids,), shape)
    if stype == "csr":
        host_ptr = np.zeros(shape[0] + 1, np.int64)
        return CSRNDArray(torch.zeros((0,), dtype=dt, device=device),
                          (torch.from_numpy(host_ptr).to(device), empty_ids),
                          shape, host_ptr)
    raise MXNetError("unknown stype %r" % stype)


empty = zeros


def array(source_array, ctx=None, dtype=None):
    if isinstance(source_array, BaseSparseNDArray):
        return source_array.copy() if ctx is None \
            else source_array.copyto(ctx)
    if hasattr(source_array, "tocsr"):
        return csr_matrix(source_array, ctx=ctx, dtype=dtype)
    raise MXNetError("use csr_matrix/row_sparse_array for dense sources")


# ---------------------------------------------------------------------------
# cast_storage
# ---------------------------------------------------------------------------

def _zero_rows(shape, like: torch.Tensor):
    return torch.zeros((0,) + tuple(shape[1:]), dtype=like.dtype,
                       device=like.device)


def cast_storage(arr: NDArray, stype: str):
    """``arr`` in storage type ``stype`` (``default``, ``row_sparse``
    or ``csr``); the array itself when it is stored so already."""
    src = arr.stype
    if stype == src:
        return arr
    if stype not in ("default", "row_sparse", "csr"):
        raise MXNetError("unknown stype %r" % stype)
    if src == "default":
        t = arr._data.detach()
        if stype == "row_sparse":
            # the rows holding a non-zero value (a host sync: their count)
            flat = t.reshape(t.shape[0], -1) if t.dim() > 1 else t[:, None]
            rows = (flat != 0).any(1).nonzero().squeeze(1)
            return RowSparseNDArray(t.index_select(0, rows), (rows,),
                                    arr.shape)
        if arr.ndim != 2:
            raise MXNetError("csr requires 2-D")
        r, c = t.nonzero(as_tuple=True)
        counts = torch.bincount(r, minlength=t.shape[0])
        ptr = torch.zeros(t.shape[0] + 1, dtype=torch.int64, device=t.device)
        ptr[1:] = torch.cumsum(counts, 0)
        return CSRNDArray(t[r, c], (ptr, c), arr.shape)
    if stype == "default":
        out = torch.zeros(arr.shape, dtype=arr._data.dtype,
                          device=arr._data.device)
        if src == "row_sparse":
            out.index_copy_(0, arr._aux[0], arr._data.detach())
        else:
            out.index_put_((arr.row_ids(), arr._aux[1]), arr._data.detach(),
                           accumulate=True)
        return NDArray(out)
    return cast_storage(cast_storage(arr, "default"), stype)


# ---------------------------------------------------------------------------
# dot
# ---------------------------------------------------------------------------

def _gather_sum(src, take, scale, put, n_out):
    """out[put[i]] += scale[i] * src[take[i]] over the stored values."""
    contrib = src.index_select(0, take) * scale[:, None].to(src.dtype)
    out = torch.zeros((n_out, src.shape[1]), dtype=contrib.dtype,
                      device=src.device)
    return out.index_add_(0, put, contrib)


class _CsrDot(torch.autograd.Function):
    """csr · W, whose gradient with respect to W is csrᵀ · dout over the
    batch's columns: a sparse COO tensor (uncoalesced) when W is a leaf,
    so that it stays row-sparse up to the leaf's gradient; dense when W
    was computed, since the ops upstream take dense gradients (the JAX
    package densifies its row-sparse cotangent there too)."""

    @staticmethod
    def forward(ctx, rhs, vals, rows, cols, m, sparse_grad):
        ctx.save_for_backward(vals, rows, cols)
        ctx.rhs_shape, ctx.sparse_grad = tuple(rhs.shape), sparse_grad
        return _gather_sum(rhs, cols, vals, rows, m)

    @staticmethod
    def backward(ctx, dout):
        vals, rows, cols = ctx.saved_tensors
        contrib = dout.index_select(0, rows) * vals[:, None].to(dout.dtype)
        if ctx.sparse_grad:
            with torch.sparse.check_sparse_tensor_invariants(enable=False):
                grad = torch.sparse_coo_tensor(cols[None], contrib,
                                               ctx.rhs_shape)
        else:
            grad = torch.zeros(ctx.rhs_shape, dtype=contrib.dtype,
                               device=contrib.device).index_add_(
                0, cols, contrib)
        return grad, None, None, None, None, None


def _csr_dot_dense(csr: CSRNDArray, rhs: torch.Tensor, transpose_a: bool):
    m, n = csr.shape
    vals, cols, rows = csr._data, csr._aux[1], csr.row_ids()
    vec = rhs.dim() == 1
    d = rhs[:, None] if vec else rhs
    from .. import autograd as _ag

    if not transpose_a and not vec and _ag.is_recording() \
            and rhs.requires_grad:
        return _CsrDot.apply(rhs, vals, rows, cols, m, rhs.is_leaf)
    with torch.set_grad_enabled(_ag.is_recording()):
        out = _gather_sum(d, rows, vals, cols, n) if transpose_a \
            else _gather_sum(d, cols, vals, rows, m)
        return out[:, 0] if vec else out


def dot(lhs, rhs, transpose_a: bool = False, transpose_b: bool = False):
    """The product of a CSR array and a dense one: csr·dense, csrᵀ·dense,
    dense·csr and dense·csrᵀ, with a vector on the dense side; any other
    mix runs on the densified arrays (the registered ``dot``)."""
    if isinstance(lhs, CSRNDArray) and not isinstance(rhs, BaseSparseNDArray):
        if transpose_b:
            raise MXNetError("dot(csr, dense, transpose_b) unsupported")
        return NDArray(_csr_dot_dense(lhs, rhs._data, transpose_a))
    if not isinstance(lhs, BaseSparseNDArray) and isinstance(rhs, CSRNDArray):
        # Dᵃ · Sᵇ = (Sᵇᵀ · Dᵃᵀ)ᵀ
        from .. import autograd as _ag

        with torch.set_grad_enabled(_ag.is_recording()):
            t = lhs._data
            vec = t.dim() == 1
            inner = t if vec else (t if transpose_a else t.t())
            out = _csr_dot_dense(rhs, inner, not transpose_b)
            return NDArray(out if vec else out.t())
    if isinstance(lhs, BaseSparseNDArray) or isinstance(rhs, BaseSparseNDArray):
        lhs = lhs.todense() if isinstance(lhs, BaseSparseNDArray) else lhs
        rhs = rhs.todense() if isinstance(rhs, BaseSparseNDArray) else rhs
    return imperative_invoke("dot", lhs, rhs, transpose_a=transpose_a,
                             transpose_b=transpose_b)[0]


# ---------------------------------------------------------------------------
# retain, row pulls, add
# ---------------------------------------------------------------------------

def _unique_rows(row_ids, device, n_rows) -> torch.Tensor:
    """Sorted unique int64 row ids on ``device``, checked to lie in
    [0, n_rows) (a host sync, as the size of a unique set is)."""
    rids = torch.unique(_index_tensor(row_ids, device))
    if rids.numel() and bool((rids[0] < 0) | (rids[-1] >= n_rows)):
        raise MXNetError("row ids out of range [0, %d)" % n_rows)
    return rids


def retain(arr: RowSparseNDArray, row_ids) -> RowSparseNDArray:
    """The stored rows of ``arr`` whose ids are in ``row_ids``."""
    if not isinstance(arr, RowSparseNDArray):
        raise MXNetError("retain expects row_sparse")
    rids = torch.unique(_index_tensor(row_ids, arr._data.device))
    stored = arr._aux[0]
    if not stored.numel() or not rids.numel():
        return RowSparseNDArray(_zero_rows(arr.shape, arr._data),
                                (stored[:0],), arr.shape)
    pos = torch.searchsorted(stored, rids).clamp_(max=stored.numel() - 1)
    keep = pos[stored.index_select(0, pos) == rids]
    return RowSparseNDArray(arr._data.index_select(0, keep),
                            (stored.index_select(0, keep),), arr.shape)


def retain_rows_into(src: NDArray, row_ids, dst) -> None:
    """``row_sparse_pull``'s write: the ``row_ids`` rows of the dense
    ``src`` into ``dst``.  A row-sparse ``dst`` holds exactly those rows;
    a dense ``dst`` gets them in place over zeros, every other row
    written too."""
    rids = _unique_rows(row_ids, src._data.device, src.shape[0])
    rows = src._data.detach().index_select(0, rids)
    if isinstance(dst, RowSparseNDArray):
        dev = dst._data.device
        dst._assign(RowSparseNDArray(rows.to(dev), (rids.to(dev),),
                                     src.shape))
    elif isinstance(dst, NDArray):
        with torch.no_grad():
            dst._data.zero_()
            dst._data.index_copy_(0, rids.to(dst._data.device),
                                  rows.to(dst._data.device, dst._data.dtype))
    else:
        raise MXNetError("bad row_sparse_pull target %r" % type(dst))


def set_rows_into(rows: np.ndarray, data: np.ndarray, dst) -> None:
    """Write already-gathered host rows into ``dst``: a row-sparse target
    takes them as they are; a dense one gets them over zeros."""
    order = np.argsort(rows, kind="stable")
    rids = _index_tensor(np.asarray(rows)[order], dst._data.device)
    vals = torch.from_numpy(np.ascontiguousarray(np.asarray(data)[order]))
    if isinstance(dst, RowSparseNDArray):
        dst._assign(RowSparseNDArray(vals.to(dst._data.device), (rids,),
                                     dst.shape))
    elif isinstance(dst, NDArray):
        with torch.no_grad():
            dst._data.zero_()
            dst._data.index_copy_(0, rids, vals.to(dst._data.device,
                                                     dst._data.dtype))
    else:
        raise MXNetError("bad row_sparse_pull target %r" % type(dst))


def add(lhs, rhs):
    """``lhs + rhs``; two row-sparse arrays sum into a row-sparse one over
    the union of their rows."""
    if isinstance(lhs, RowSparseNDArray) and isinstance(rhs, RowSparseNDArray):
        if lhs.shape != rhs.shape:
            raise MXNetError("shape mismatch")
        li, ri = lhs._aux[0], rhs._aux[0].to(lhs._data.device)
        rows = torch.unique(torch.cat([li, ri]))
        out = torch.zeros((rows.numel(),) + tuple(lhs.shape[1:]),
                          dtype=lhs._data.dtype, device=lhs._data.device)
        out.index_add_(0, torch.searchsorted(rows, li), lhs._data.detach())
        out.index_add_(0, torch.searchsorted(rows, ri),
                       rhs._data.detach().to(lhs._data.device))
        return RowSparseNDArray(out, (rows,), lhs.shape)
    lhs = lhs.todense() if isinstance(lhs, BaseSparseNDArray) else lhs
    rhs = rhs.todense() if isinstance(rhs, BaseSparseNDArray) else rhs
    return lhs + rhs


elemwise_add = add
