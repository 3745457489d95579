"""NDArray of the PyTorch port: the imperative tensor.

Counterpart of ``mxtpu/ndarray/ndarray.py``.  An NDArray holds one
``torch.Tensor`` (``_data``) on a device; its ``ctx`` is that tensor's
``torch.device``.  Every operator call goes through
:func:`imperative_invoke`, which runs the registered op on the tensors
(with grad enabled only under ``autograd.record()``).  Writes into an
array (``a[:] = x``, ``copyto``, the optimizer and the executor) copy
into its tensor in place, so every holder of the array sees them.

``save``/``load`` write and read the JAX package's container (an
``np.savez`` archive with a ``__keys__`` entry), so one ``.params`` file
reads in both packages.  Sparse arrays are not ported.
"""
from __future__ import annotations

import os
import tempfile
from typing import Optional, Tuple

import numpy as np
import torch

from ..base import (MXNetError, _Null, dtype_of_torch, np_dtype,
                    shape2tuple, torch_dtype)
from ..context import resolve
from ..ops import registry as _reg
from .. import autograd as _ag

__all__ = ["NDArray", "imperative_invoke", "array", "zeros", "ones", "full",
           "waitall", "save", "load"]


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
    if dt == torch.bfloat16:
        t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
    else:
        t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=device, dtype=dt, copy=True)


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
    def ctx(self) -> torch.device:
        return self._data.device

    context = ctx

    @property
    def grad(self) -> Optional["NDArray"]:
        return self._grad

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

    def __float__(self):
        return float(self.asscalar())

    def __bool__(self):
        if self.size == 1:
            return bool(self.asscalar())
        raise MXNetError("The truth value of an NDArray with multiple "
                         "elements is ambiguous")

    def __len__(self):
        if not self.shape:
            raise TypeError("len() of unsized object")
        return self.shape[0]

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
        if isinstance(other, NDArray):
            other._set_data(self._data)
            return other
        return NDArray(self._data.detach().to(resolve(other), copy=True))

    def as_in_context(self, ctx) -> "NDArray":
        if resolve(ctx) == self.ctx:
            return self
        return self.copyto(ctx)

    as_in_ctx = as_in_context

    def detach(self) -> "NDArray":
        return NDArray(self._data.detach())

    # -- autograd -----------------------------------------------------------
    def attach_grad(self, grad_req: str = "write"):
        """Attach a gradient buffer: this array becomes a marked
        variable of ``autograd``."""
        _ag.mark_variables([self], [NDArray(torch.zeros_like(
            self._data, requires_grad=False))], grad_req)

    def backward(self, out_grad: Optional["NDArray"] = None,
                 retain_graph: bool = False, train_mode: bool = True):
        _ag.backward([self], [out_grad], retain_graph=retain_graph,
                     train_mode=train_mode)

    # -- indexing -----------------------------------------------------------
    @staticmethod
    def _canon_index(key):
        if isinstance(key, NDArray):
            return key._data.long()
        if isinstance(key, tuple):
            return tuple(k._data.long() if isinstance(k, NDArray) else k
                         for k in key)
        return key

    def __getitem__(self, key):
        key = self._canon_index(key)
        with torch.set_grad_enabled(_ag.is_recording()):
            return NDArray(self._data[key])

    def __setitem__(self, key, value):
        key = self._canon_index(key)
        if isinstance(value, NDArray):
            value = value._data
        elif not isinstance(value, torch.Tensor):
            value = torch.as_tensor(np.asarray(value), device=self.ctx)
        with torch.no_grad():
            self._data[key] = value.to(self._data.dtype)

    # -- shape manipulation (through the registered ops) --------------------
    def reshape(self, *shape, **kwargs) -> "NDArray":
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        if not shape:
            shape = kwargs.get("shape", ())
        return imperative_invoke("Reshape", self, shape=tuple(shape))[0]

    def transpose(self, *axes) -> "NDArray":
        if len(axes) == 1 and isinstance(axes[0], (list, tuple)):
            axes = tuple(axes[0])
        return imperative_invoke("transpose", self,
                                 axes=axes if axes else None)[0]

    def flatten(self) -> "NDArray":
        return imperative_invoke("Flatten", self)[0]

    def _reduce(self, op: str, axis=None, keepdims=False) -> "NDArray":
        return imperative_invoke(op, self, axis=axis, keepdims=keepdims)[0]

    def sum(self, axis=None, keepdims=False) -> "NDArray":
        return self._reduce("sum", axis, keepdims)

    def mean(self, axis=None, keepdims=False) -> "NDArray":
        return self._reduce("mean", axis, keepdims)

    def argmax(self, axis=None, keepdims=False) -> "NDArray":
        return self._reduce("argmax", axis, keepdims)

    # -- arithmetic ----------------------------------------------------------
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
            return imperative_invoke(self._BROADCAST_NAME[op_ew], a, b)[0]
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

    def __neg__(self):
        return imperative_invoke("negative", self)[0]

    def __gt__(self, other):
        return self._binary(other, "_greater", "_greater_scalar")

    def _inplace_result(self, res):
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


# ---------------------------------------------------------------------------
# Imperative invoke: the funnel every op call goes through
# ---------------------------------------------------------------------------

def imperative_invoke(op_name: str, *inputs, out=None,
                      _full_outputs: bool = False, **attrs):
    """Run the registered op ``op_name`` on NDArrays (numpy arrays and
    scalars become arrays on the first array's device); returns a tuple
    of NDArrays.  An op without array inputs runs on ``ctx`` (default:
    the card)."""
    opdef = _reg.get_op(op_name)
    attrs = {k: v for k, v in attrs.items()
             if v is not None and v is not _Null}
    if opdef.train_aware and "is_train" not in attrs:
        attrs["is_train"] = _ag.is_training()
    ctx = attrs.pop("ctx", None)
    device = None
    for x in inputs:
        if isinstance(x, NDArray):
            device = x.ctx
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
        device = resolve(ctx)
        attrs["device"] = device
    elif device is None:
        device = tensors[0].device
    gen = None
    if opdef.needs_rng:
        from .. import random as _rnd

        gen = _rnd.generator(device)
    with torch.set_grad_enabled(_ag.is_recording() and opdef.differentiable):
        outs = _reg.invoke(opdef, tensors, attrs, gen)
    results = [NDArray(o) for o in outs]
    if not _full_outputs:
        results = results[:opdef.n_visible_outputs(attrs)]
    if out is not None:
        outs_list = out if isinstance(out, (list, tuple)) else [out]
        for dst, src in zip(outs_list, results):
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
            or resolve(ctx) == source_array.ctx \
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
    return NDArray(_from_numpy(a, resolve(ctx), dtype))


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
