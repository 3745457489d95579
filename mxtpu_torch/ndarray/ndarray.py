"""NDArray of the PyTorch port: the imperative tensor.

Counterpart of ``mxtpu/ndarray/ndarray.py``.  An NDArray holds one
``torch.Tensor`` (``_data``) on a device; its ``ctx`` is the
``Context`` of that tensor's device.  Every operator call goes through
:func:`imperative_invoke`, which runs the registered op on the tensors
(with grad enabled only under ``autograd.record()``).  Writes into an
array (``a[:] = x``, ``copyto``, the optimizer and the executor) copy
into its tensor in place, so every holder of the array sees them.  No
two arrays share memory, as in the JAX package, whose arrays are
immutable: an op output or a subscript that torch returns as a view
of its input (``Reshape``, ``transpose``, ``a[1]``, ``a[:, 2]``...) is
copied, and ``detach`` copies.  Only ``a[:]`` is ``a`` itself.

DLPack: ``to_dlpack_for_read`` hands out a capsule over the array's own
tensor (``torch.utils.dlpack``); ``to_dlpack_for_write`` raises, as the
JAX package's does: writes through a capsule would bypass autograd's
record of the tensor's versions and share the array's memory with
another framework.  ``from_dlpack`` takes a capsule or any object with
``__dlpack__`` without a copy.

``save``/``load`` write and read the JAX package's container (an
``np.savez`` archive with a ``__keys__`` entry), so one ``.params`` file
reads in both packages.  The sparse arrays (``stype`` ``csr`` and
``row_sparse``) live in :mod:`.sparse`; an op without a sparse form
runs on the densified array (the reference's storage fallback).
"""
from __future__ import annotations

import os
import tempfile
from typing import Optional, Tuple

import numpy as np
import torch

from ..base import (MXNetError, _Null, dtype_of_torch, np_dtype,
                    shape2tuple, torch_dtype)
from .. import context as _context
from ..context import Context, as_context, place, resolve
from ..ops import registry as _reg
from .. import autograd as _ag

__all__ = ["NDArray", "imperative_invoke", "array", "zeros", "ones", "full",
           "empty", "arange", "eye", "concat", "stack", "split", "moveaxis",
           "maximum", "minimum", "from_numpy", "from_dlpack",
           "to_dlpack_for_read", "to_dlpack_for_write", "waitall", "save",
           "load"]


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy (never a view of the array's tensor)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.float().cpu().numpy().astype(np_dtype("bfloat16"))
    return t.cpu().numpy().copy() if t.device.type == "cpu" \
        else t.cpu().numpy()


def _from_numpy(a: np.ndarray, device, dtype=None) -> torch.Tensor:
    """A copy of ``a`` on ``device`` (never a view of the numpy array)."""
    dt = torch_dtype(a.dtype if dtype is None else dtype)
    # asarray(order="C") keeps a 0-d array 0-d (ascontiguousarray does not)
    if dt == torch.bfloat16:
        a = np.asarray(a, dtype=np.float32, order="C")
    else:
        a = np.asarray(a, order="C")
    if not a.flags.writeable:  # a dataset read with np.frombuffer
        a = a.copy()
    return torch.from_numpy(a).to(device=device, dtype=dt, copy=True)


class NDArray(object):
    """A fixed-size multi-dimensional array on a device."""

    __slots__ = ("_data", "_grad", "_grad_req", "__weakref__")

    def __init__(self, data: torch.Tensor):
        self._data = data
        self._grad: Optional["NDArray"] = None
        self._grad_req = "null"

    # -- payload ------------------------------------------------------------
    def _set_data(self, value):
        """In-place write of ``value`` (a tensor or an NDArray) into this
        array's tensor, cast to its dtype."""
        if isinstance(value, NDArray):
            value = value._data
        if tuple(value.shape) != self.shape:
            raise MXNetError("shape mismatch in write: %s into %s"
                             % (tuple(value.shape), self.shape))
        with torch.no_grad():
            self._data.copy_(value)

    # -- basic properties ---------------------------------------------------
    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return dtype_of_torch(self._data.dtype)

    @property
    def size(self) -> int:
        return self._data.numel()

    @property
    def ndim(self) -> int:
        return self._data.dim()

    @property
    def ctx(self) -> Context:
        """The array's context: ``gpu(i)``, ``cpu(0)``, or
        ``cpu_pinned(0)``/``cpu_shared(0)`` for a page-locked or shared
        host tensor (a tensor on another torch device, such as ``meta``
        in shape inference, gives its ``torch.device``)."""
        dev = self._data.device
        if dev.type == "cuda":
            return Context("gpu", dev.index or 0)
        if dev.type != "cpu":
            return dev
        if self._data.is_shared():
            return Context("cpu_shared", 0)
        if torch.cuda.is_available() and self._data.is_pinned():
            return Context("cpu_pinned", 0)
        return Context("cpu", 0)

    context = ctx

    @property
    def stype(self) -> str:
        return "default"

    @property
    def grad(self) -> Optional["NDArray"]:
        return self._grad

    @property
    def T(self) -> "NDArray":
        if self.ndim < 2:
            return self
        return imperative_invoke("transpose", self)[0]

    # -- sync / host transfer ----------------------------------------------
    def wait_to_read(self):
        if self._data.is_cuda:
            torch.cuda.synchronize(self._data.device)
        return self

    def asnumpy(self) -> np.ndarray:
        return _to_numpy(self._data)

    def asscalar(self):
        if self.size != 1:
            raise MXNetError("The current array is not a scalar")
        return self.asnumpy().reshape(())[()]

    def item(self):
        return self.asscalar()

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    # -- DLPack -------------------------------------------------------------
    def to_dlpack_for_read(self):
        """A DLPack capsule over this array's tensor, after its pending
        work is done."""
        from torch.utils import dlpack

        return dlpack.to_dlpack(self.wait_to_read()._data.detach())

    def to_dlpack_for_write(self):
        """Raises, as the JAX package's does (see the module's
        docstring), naming the supported way."""
        raise MXNetError(
            "to_dlpack_for_write is not supported: writes through the "
            "capsule would bypass autograd's record of this array. Export "
            "with to_dlpack_for_read, write in the consumer framework, and "
            "import the result with nd.from_dlpack")

    @property
    def dlpack(self):
        return self.to_dlpack_for_read()

    def __dlpack__(self, **kwargs):
        return self.wait_to_read()._data.detach().__dlpack__(**kwargs)

    def __dlpack_device__(self):
        return self._data.__dlpack_device__()

    def __bool__(self):
        if self.size == 1:
            return bool(self.asscalar())
        raise MXNetError("The truth value of an NDArray with multiple "
                         "elements is ambiguous")

    def __len__(self):
        if not self.shape:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __repr__(self):
        return "%s\n<NDArray %s @%s>" % (self.asnumpy(),
                                         "x".join(map(str, self.shape)),
                                         self.ctx)

    # -- conversion / movement ----------------------------------------------
    def astype(self, dtype, copy: bool = True) -> "NDArray":
        if self._data.dtype == torch_dtype(dtype):
            # Cast to the same dtype hands back its input tensor
            return self.copy() if copy else self
        return imperative_invoke("Cast", self,
                                 dtype=str(np_dtype(dtype)))[0]

    def copy(self) -> "NDArray":
        return imperative_invoke("_copy", self)[0]

    def copyto(self, other) -> "NDArray":
        """Copy into the array ``other`` (in place, cast to its dtype),
        or onto the device ``other``."""
        if isinstance(other, NDArray) and other.stype != "default":
            from .sparse import cast_storage

            return cast_storage(self, other.stype).copyto(other)
        if isinstance(other, NDArray):
            other._set_data(self._data)
            return other
        return NDArray(place(self._data.detach().to(resolve(other),
                                                    copy=True), other))

    def as_in_context(self, ctx) -> "NDArray":
        if as_context(ctx) == self.ctx:
            return self
        return self.copyto(ctx)

    as_in_ctx = as_in_context

    def detach(self) -> "NDArray":
        return NDArray(self._data.detach().clone())

    def tostype(self, stype: str):
        if stype == "default":
            return self
        from .sparse import cast_storage

        return cast_storage(self, stype)

    # -- autograd -----------------------------------------------------------
    def attach_grad(self, grad_req: str = "write", stype=None):
        """Attach a gradient buffer: this array becomes a marked
        variable of ``autograd``.  ``stype="row_sparse"`` makes the
        buffer a ``RowSparseNDArray``, which ``backward`` fills with
        the rows the gradient touches."""
        if stype == "row_sparse":
            from .sparse import zeros as _sparse_zeros

            grad = _sparse_zeros("row_sparse", self.shape, ctx=self.ctx,
                                 dtype=self._data.dtype)
        else:
            grad = NDArray(torch.zeros_like(self._data, requires_grad=False))
        _ag.mark_variables([self], [grad], grad_req)

    def backward(self, out_grad: Optional["NDArray"] = None,
                 retain_graph: bool = False, train_mode: bool = True):
        _ag.backward([self], [out_grad], retain_graph=retain_graph,
                     train_mode=train_mode)

    # -- indexing -----------------------------------------------------------
    def _canon_index(self, key):
        """(key, axes): NDArray subscripts become index tensors, and each
        slice with a negative step becomes the positive-step slice that
        picks the same elements from the array flipped along ``axes``
        (torch has no negative strides)."""
        if isinstance(key, NDArray):
            key = key._data.long()
        elif isinstance(key, tuple):
            key = tuple(k._data.long() if isinstance(k, NDArray) else k
                        for k in key)
        items = key if isinstance(key, tuple) else (key,)
        if not any(isinstance(k, slice) and k.step is not None
                   and k.step < 0 for k in items):
            return key, ()

        def width(k):  # the input axes a subscript item consumes
            if k is None or k is Ellipsis:
                return 0
            if isinstance(k, (torch.Tensor, np.ndarray)) \
                    and k.dtype in (torch.bool, np.bool_):
                return k.ndim
            return 1

        axis, axes, out = 0, [], []
        for k in items:
            if k is Ellipsis:
                axis += self.ndim - sum(width(j) for j in items)
            elif isinstance(k, slice) and k.step is not None and k.step < 0:
                n = self.shape[axis]
                picked = range(*k.indices(n))
                k = slice(0, 0) if not picked else \
                    slice(n - 1 - picked[0], n - picked[-1], -k.step)
                axes.append(axis)
            axis += width(k)
            out.append(k)
        return tuple(out), tuple(axes)

    def __getitem__(self, key):
        if isinstance(key, slice) and key == slice(None):
            return self
        key, axes = self._canon_index(key)
        with torch.set_grad_enabled(_ag.is_recording()):
            src = self._data.flip(axes) if axes else self._data
            return NDArray(_unshared(src[key], (self._data,)))

    def __setitem__(self, key, value):
        key, axes = self._canon_index(key)
        if isinstance(value, NDArray):
            value = value._data
        elif not isinstance(value, torch.Tensor):
            value = torch.as_tensor(np.asarray(value),
                                    device=self._data.device)
        with torch.no_grad():
            if not axes:
                self._data[key] = value.to(self._data.dtype)
                return
            flipped = self._data.flip(axes)
            flipped[key] = value.to(self._data.dtype)
            self._data.copy_(flipped.flip(axes))

    # -- methods over the registered ops --------------------------------------
    def _op(self, name, *args, **attrs) -> "NDArray":
        return imperative_invoke(name, self, *args, **attrs)[0]

    def reshape(self, *shape, **kwargs) -> "NDArray":
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        if not shape:
            shape = kwargs.get("shape", ())
        return self._op("Reshape", shape=tuple(shape))

    def reshape_like(self, other) -> "NDArray":
        return self._op("reshape_like", other)

    def expand_dims(self, axis) -> "NDArray":
        return self._op("expand_dims", axis=axis)

    def squeeze(self, axis=None) -> "NDArray":
        return self._op("squeeze", axis=axis)

    def transpose(self, *axes) -> "NDArray":
        if len(axes) == 1 and isinstance(axes[0], (list, tuple)):
            axes = tuple(axes[0])
        return self._op("transpose", axes=axes if axes else None)

    def flatten(self) -> "NDArray":
        return self._op("Flatten")

    def swapaxes(self, dim1, dim2) -> "NDArray":
        return self._op("SwapAxis", dim1=dim1, dim2=dim2)

    def flip(self, axis) -> "NDArray":
        return self._op("reverse", axis=axis)

    def broadcast_to(self, shape) -> "NDArray":
        return self._op("broadcast_to", shape=tuple(shape))

    def broadcast_like(self, other) -> "NDArray":
        return self._op("broadcast_like", other)

    def slice(self, begin, end, step=None) -> "NDArray":
        return self._op("slice", begin=tuple(begin), end=tuple(end),
                        step=tuple(step) if step else None)

    def slice_axis(self, axis, begin, end) -> "NDArray":
        return self._op("slice_axis", axis=axis, begin=begin, end=end)

    def take(self, indices, axis=0, mode="clip") -> "NDArray":
        return self._op("take", indices, axis=axis, mode=mode)

    def one_hot(self, depth, on_value=1.0, off_value=0.0,
                dtype="float32") -> "NDArray":
        return self._op("one_hot", depth=depth, on_value=on_value,
                        off_value=off_value, dtype=dtype)

    def pick(self, index, axis=-1, keepdims=False, mode="clip") -> "NDArray":
        return self._op("pick", index, axis=axis, keepdims=keepdims,
                        mode=mode)

    def dot(self, other, **kw) -> "NDArray":
        return self._op("dot", other, **kw)

    def clip(self, a_min, a_max) -> "NDArray":
        return self._op("clip", a_min=a_min, a_max=a_max)

    def softmax(self, axis=-1) -> "NDArray":
        return self._op("softmax", axis=axis)

    def log_softmax(self, axis=-1) -> "NDArray":
        return self._op("log_softmax", axis=axis)

    def _reduce(self, op: str, axis=None, keepdims=False) -> "NDArray":
        return self._op(op, axis=axis, keepdims=keepdims)

    def sum(self, axis=None, keepdims=False) -> "NDArray":
        return self._reduce("sum", axis, keepdims)

    def mean(self, axis=None, keepdims=False) -> "NDArray":
        return self._reduce("mean", axis, keepdims)

    def prod(self, axis=None, keepdims=False) -> "NDArray":
        return self._reduce("prod", axis, keepdims)

    def max(self, axis=None, keepdims=False) -> "NDArray":
        return self._reduce("max", axis, keepdims)

    def min(self, axis=None, keepdims=False) -> "NDArray":
        return self._reduce("min", axis, keepdims)

    def argmax(self, axis=None, keepdims=False) -> "NDArray":
        return self._reduce("argmax", axis, keepdims)

    def argmin(self, axis=None, keepdims=False) -> "NDArray":
        return self._reduce("argmin", axis, keepdims)

    def norm(self, ord=2, axis=None, keepdims=False) -> "NDArray":
        return self._op("norm", ord=ord, axis=axis, keepdims=keepdims)

    def topk(self, axis=-1, k=1, ret_typ="indices",
             is_ascend=False) -> "NDArray":
        return self._op("topk", axis=axis, k=k, ret_typ=ret_typ,
                        is_ascend=is_ascend)

    def argsort(self, axis=-1, is_ascend=True) -> "NDArray":
        return self._op("argsort", axis=axis, is_ascend=is_ascend)

    def sort(self, axis=-1, is_ascend=True) -> "NDArray":
        return self._op("sort", axis=axis, is_ascend=is_ascend)

    # -- arithmetic -----------------------------------------------------------
    _BROADCAST_NAME = {"elemwise_add": "broadcast_add",
                       "elemwise_sub": "broadcast_sub",
                       "elemwise_mul": "broadcast_mul",
                       "elemwise_div": "broadcast_div"}

    def _binary(self, other, op_ew: str, op_sc: str,
                reverse_sc: Optional[str] = None, swap: bool = False):
        if isinstance(other, NDArray):
            a, b = (other, self) if swap else (self, other)
            if a.shape == b.shape:
                return imperative_invoke(op_ew, a, b)[0]
            return imperative_invoke(self._BROADCAST_NAME.get(
                op_ew, "broadcast" + op_ew), a, b)[0]
        if isinstance(other, (int, float, np.generic)):
            name = reverse_sc if (swap and reverse_sc) else op_sc
            return imperative_invoke(name, self, scalar=float(other))[0]
        return NotImplemented

    def __add__(self, other):
        return self._binary(other, "elemwise_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, other):
        return self._binary(other, "elemwise_sub", "_minus_scalar")

    def __rsub__(self, other):
        return self._binary(other, "elemwise_sub", "_minus_scalar",
                            "_rminus_scalar", swap=True)

    def __mul__(self, other):
        return self._binary(other, "elemwise_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binary(other, "elemwise_div", "_div_scalar")

    def __rtruediv__(self, other):
        return self._binary(other, "elemwise_div", "_div_scalar",
                            "_rdiv_scalar", swap=True)

    def __mod__(self, other):
        return self._binary(other, "_mod", "_mod_scalar")

    def __rmod__(self, other):
        return self._binary(other, "_mod", "_mod_scalar", "_rmod_scalar",
                            swap=True)

    def __pow__(self, other):
        return self._binary(other, "_power", "_power_scalar")

    def __rpow__(self, other):
        return self._binary(other, "_power", "_power_scalar",
                            "_rpower_scalar", swap=True)

    def __matmul__(self, other):
        return self._op("dot", other)

    def __neg__(self):
        return self._op("negative")

    def __abs__(self):
        return self._op("abs")

    # comparisons give 1 or 0 in the left operand's dtype
    def __eq__(self, other):
        if other is None:
            return False
        return self._binary(other, "_equal", "_equal_scalar")

    def __ne__(self, other):
        if other is None:
            return True
        return self._binary(other, "_not_equal", "_not_equal_scalar")

    def __gt__(self, other):
        return self._binary(other, "_greater", "_greater_scalar")

    def __ge__(self, other):
        return self._binary(other, "_greater_equal",
                            "_greater_equal_scalar")

    def __lt__(self, other):
        return self._binary(other, "_lesser", "_lesser_scalar")

    def __le__(self, other):
        return self._binary(other, "_lesser_equal", "_lesser_equal_scalar")

    def _inplace_result(self, res):
        if not _ag.is_recording() and _ag._owner(self._data) is self \
                and res.shape == self.shape:
            # a marked variable outside record(): write into its leaf
            # tensor, which backward finds again
            self._set_data(res)
            return self
        # rebind, so that a result recorded under autograd keeps its link
        self._data = res._data
        return self

    def __iadd__(self, other):
        return self._inplace_result(self.__add__(other))

    def __isub__(self, other):
        return self._inplace_result(self.__sub__(other))

    def __imul__(self, other):
        return self._inplace_result(self.__mul__(other))

    def __itruediv__(self, other):
        return self._inplace_result(self.__truediv__(other))

    __hash__ = object.__hash__


def _unary_method(op):
    def method(self) -> "NDArray":
        return imperative_invoke(op, self)[0]

    method.__name__ = op
    method.__doc__ = "``nd.%s`` of this array." % op
    return method


for _op_name in ("abs", "sign", "sqrt", "square", "exp", "log", "relu",
                 "sigmoid", "tanh", "zeros_like", "ones_like"):
    setattr(NDArray, _op_name, _unary_method(_op_name))


# ---------------------------------------------------------------------------
# Imperative invoke: the funnel every op call goes through
# ---------------------------------------------------------------------------

def _unshared(t: torch.Tensor, sources) -> torch.Tensor:
    """``t``, or a copy of it where it shares memory with one of the
    tensors ``sources`` (a view that torch returned for an op or a
    subscript); the copy is recorded under autograd like the view."""
    if t.layout != torch.strided or t.numel() == 0:
        return t
    ptr = t.untyped_storage().data_ptr()
    for s in sources:
        if isinstance(s, torch.Tensor) and s.layout == torch.strided \
                and s.untyped_storage().data_ptr() == ptr:
            return t.clone()
    return t


def imperative_invoke(op_name: str, *inputs, out=None,
                      _full_outputs: bool = False, **attrs):
    """Run the registered op ``op_name`` on NDArrays (numpy arrays and
    scalars become arrays on the first array's device); returns a tuple
    of NDArrays.  An op without array inputs runs on ``ctx`` (default:
    the card)."""
    opdef = _reg.get_op(op_name)
    attrs = {k: v for k, v in attrs.items()
             if v is not None and v is not _Null}
    # storage fallback: ops take sparse arrays densified
    inputs = [x.todense() if isinstance(x, NDArray) and x.stype != "default"
              else x for x in inputs]
    if opdef.train_aware and "is_train" not in attrs:
        attrs["is_train"] = _ag.is_training()
    ctx = attrs.pop("ctx", None)
    device = None
    for x in inputs:
        if isinstance(x, NDArray):
            device = x._data.device
            break
    tensors = []
    for x in inputs:
        if isinstance(x, NDArray):
            tensors.append(x._data)
        elif isinstance(x, torch.Tensor):
            tensors.append(x)
        else:
            tensors.append(array(x, ctx=device if device is not None
                                 else ctx)._data)
    if not tensors:
        ctx = _context.default_ctx() if ctx is None else ctx
        device = resolve(ctx)
        attrs["device"] = device
    elif device is None:
        device = tensors[0].device
    gen = None
    if opdef.needs_rng:
        from .. import random as _rnd

        gen = _rnd.generator(device)
    with torch.set_grad_enabled(_ag.is_recording() and opdef.differentiable):
        if (opdef.name == "_contrib_SparseEmbedding"
                or (opdef.name == "Embedding" and attrs.get("sparse_grad"))) \
                and _ag.is_recording():
            # recorded imperatively, the lookup's weight gradient is
            # row-sparse (the JAX package's _record_embedding_sparse);
            # traced into a graph, the op's gradient is dense
            from ..ops.indexing import embedding_sparse_grad

            outs = (embedding_sparse_grad(*tensors),)
        else:
            outs = _reg.invoke(opdef, tensors, attrs, gen)
    results = [NDArray(_unshared(o, tensors) if tensors else place(o, ctx))
               for o in outs]
    if not _full_outputs:
        results = results[:opdef.n_visible_outputs(attrs)]
    if out is not None:
        outs_list = out if isinstance(out, (list, tuple)) else [out]
        for dst, src in zip(outs_list, results):
            if dst.stype != "default":
                raise MXNetError("out= with %s storage is not supported for "
                                 "%s" % (dst.stype, op_name))
            dst._set_data(src._data)
        return tuple(outs_list)
    return tuple(results)


# ---------------------------------------------------------------------------
# Creation / utility functions
# ---------------------------------------------------------------------------

def array(source_array, ctx=None, dtype=None) -> NDArray:
    """An array on ``ctx`` (default: the card) from an NDArray, a numpy
    array, a list or a scalar.  numpy sources keep their dtype (float64
    becomes float32); lists and scalars default to float32."""
    if isinstance(source_array, NDArray):
        res = source_array.copy() if ctx is None \
            or as_context(ctx) == source_array.ctx \
            else source_array.as_in_context(ctx)
        if dtype is not None and res.dtype != np_dtype(dtype):
            res = res.astype(dtype)
        return res
    if dtype is None:
        dtype = source_array.dtype if isinstance(source_array, np.ndarray) \
            else np.float32
        if np.dtype(dtype) == np.float64:
            dtype = np.float32
    a = np.asarray(source_array)
    if str(dtype) != "bfloat16":
        a = a.astype(np_dtype(dtype), copy=False)
    ctx = _context.default_ctx() if ctx is None else ctx
    return NDArray(place(_from_numpy(a, resolve(ctx), dtype), ctx))


def zeros(shape, ctx=None, dtype=None, **kwargs) -> NDArray:
    return imperative_invoke("_zeros", shape=shape2tuple(shape),
                             dtype=str(np_dtype(dtype)), ctx=ctx)[0]


def ones(shape, ctx=None, dtype=None, **kwargs) -> NDArray:
    return imperative_invoke("_ones", shape=shape2tuple(shape),
                             dtype=str(np_dtype(dtype)), ctx=ctx)[0]


def full(shape, val, ctx=None, dtype=None, **kwargs) -> NDArray:
    return imperative_invoke("_full", shape=shape2tuple(shape),
                             value=float(val), dtype=str(np_dtype(dtype)),
                             ctx=ctx)[0]


def empty(shape, ctx=None, dtype=None) -> NDArray:
    return zeros(shape, ctx=ctx, dtype=dtype)


def from_numpy(a: np.ndarray, ctx=None) -> NDArray:
    return array(a, ctx=ctx)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None,
           dtype=None) -> NDArray:
    return imperative_invoke("_arange", start=float(start),
                             stop=float(stop) if stop is not None else None,
                             step=float(step), repeat=int(repeat),
                             dtype=str(np_dtype(dtype)), ctx=ctx)[0]


def eye(N, M=0, k=0, ctx=None, dtype=None) -> NDArray:
    return imperative_invoke("_eye", N=int(N), M=int(M), k=int(k),
                             dtype=str(np_dtype(dtype)), ctx=ctx)[0]


def _arrays(arrays):
    if len(arrays) == 1 and isinstance(arrays[0], (list, tuple)):
        return tuple(arrays[0])
    return arrays


def concat(*arrays, dim: int = 1) -> NDArray:
    return imperative_invoke("Concat", *_arrays(arrays), dim=dim)[0]


def stack(*arrays, axis: int = 0) -> NDArray:
    return imperative_invoke("stack", *_arrays(arrays), axis=axis)[0]


def split(data, num_outputs, axis=1, squeeze_axis=False):
    outs = imperative_invoke("SliceChannel", data, num_outputs=num_outputs,
                             axis=axis, squeeze_axis=squeeze_axis)
    return list(outs) if len(outs) > 1 else outs[0]


def moveaxis(data, source, destination) -> NDArray:
    return imperative_invoke("moveaxis", data, source=source,
                             destination=destination)[0]


def _commutative_binary(name, op_ew, op_sc, host_fn, host_ew):
    def fn(lhs, rhs):
        if not isinstance(lhs, NDArray) and not isinstance(rhs, NDArray):
            if isinstance(lhs, (int, float, np.generic)) and \
                    isinstance(rhs, (int, float, np.generic)):
                return host_fn(lhs, rhs)
            return host_ew(lhs, rhs)
        if isinstance(rhs, NDArray) and not isinstance(lhs, NDArray):
            lhs, rhs = rhs, lhs  # commutative
        if not isinstance(rhs, (NDArray, int, float, np.generic)):
            rhs = array(rhs, ctx=lhs.ctx)
        return lhs._binary(rhs, op_ew, op_sc)

    fn.__name__ = fn.__qualname__ = name
    fn.__doc__ = "Elementwise %s of arrays or scalars, broadcasting." % name
    return fn


maximum = _commutative_binary("maximum", "_maximum", "_maximum_scalar",
                              max, np.maximum)
minimum = _commutative_binary("minimum", "_minimum", "_minimum_scalar",
                              min, np.minimum)


def from_dlpack(ext_tensor) -> NDArray:
    """An array over a DLPack capsule or an object with ``__dlpack__``
    (a torch, numpy or cupy tensor), sharing its memory."""
    from torch.utils import dlpack

    return NDArray(dlpack.from_dlpack(ext_tensor))


def to_dlpack_for_read(data: NDArray):
    return data.to_dlpack_for_read()


def to_dlpack_for_write(data: NDArray):
    return data.to_dlpack_for_write()


def waitall():
    """Block until the card has finished all queued work."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def save(fname, data):
    """Save an NDArray, a list or a dict of them (``fname`` may be a
    path or a writable binary file): the JAX package's npz container."""
    if isinstance(data, NDArray):
        payload, keys = {"0": data.asnumpy()}, []
    elif isinstance(data, (list, tuple)):
        payload, keys = {str(i): d.asnumpy() for i, d in enumerate(data)}, []
    elif isinstance(data, dict):
        payload = {k: v.asnumpy() for k, v in data.items()}
        keys = list(data)
    else:
        raise TypeError("unsupported data for save: %r" % type(data))
    kw = dict(__keys__=np.array(keys, dtype=object), **payload)
    if hasattr(fname, "write"):
        np.savez(fname, **kw)
        return
    # temp file and rename: a crash mid-save never truncates a file
    d = os.path.dirname(os.path.abspath(fname))
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp-")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **kw)
        os.replace(tmp, fname)
    except BaseException:
        os.unlink(tmp)
        raise


def load(fname, ctx=None):
    """Load what ``save`` wrote (here or in the JAX package) onto
    ``ctx`` (default: the card): a dict when it was saved from one,
    else a list."""
    with np.load(fname, allow_pickle=True) as zf:
        keys = list(zf["__keys__"]) if "__keys__" in zf else []
        names = [k for k in zf.files if k != "__keys__"]
        if keys:
            return {str(k): array(zf[str(k)], ctx=ctx) for k in keys}
        try:
            return [array(zf[n], ctx=ctx) for n in sorted(names, key=int)]
        except ValueError:
            return {n: array(zf[n], ctx=ctx) for n in names}
