"""Parameter, Constant and ParameterDict of the PyTorch port.

Counterpart of ``mxtpu/gluon/parameter.py``, with the same deferred
initialisation: a shape may hold unknown (0) entries at construction,
and ``initialize()`` waits until the first forward has inferred it.  A
Parameter holds one NDArray per device (one device in this port).  With
a ``grad_req`` other than ``null`` that array is a marked variable of
``autograd`` (a leaf tensor that requires grad), so a recorded forward,
hybridized or not, reaches it; everything that writes a Parameter
(``set_data``, the Trainer's update) writes into that tensor in place,
so the leaf stays the one ``backward`` finds.  With
``grad_stype="row_sparse"`` the gradient is a ``RowSparseNDArray``
(``nn.Embedding(sparse_grad=True)``), which the Trainer's optimizer
updates lazily.  ``stype`` is stored as given, and the weight itself
stays dense whatever it says, as in the JAX package.

:func:`load_numpy` copies ``{name: numpy array}`` into a block's
parameters by name: the bridge from the JAX package's weights, whose
traced names equal the port's.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np

from ..base import MXNetError, np_dtype
from ..context import as_context, current_context, resolve
from ..ndarray.ndarray import NDArray, array as nd_array, zeros as nd_zeros
from .. import initializer as _init_mod

__all__ = ["DeferredInitializationError", "Parameter", "Constant",
           "ParameterDict", "load_numpy"]


class DeferredInitializationError(MXNetError):
    """A Parameter was read before its shape was known."""


def _ctx_list(ctx):
    if ctx is None:
        return [current_context()]
    if isinstance(ctx, (list, tuple)):
        return [resolve(c) for c in ctx]
    return [resolve(ctx)]


class Parameter(object):
    def __init__(self, name, grad_req="write", shape=None, dtype=np.float32,
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default"):
        if grad_stype not in ("default", "row_sparse"):
            raise MXNetError("unknown grad_stype %r" % grad_stype)
        self._stype = stype
        self._grad_stype = grad_stype
        self._var = None
        self._data: Optional[List[NDArray]] = None
        self._grad: Optional[List[NDArray]] = None
        self._deferred_init = ()
        self.name = name
        if isinstance(shape, int):
            shape = (shape,)
        self._shape = tuple(shape) if shape is not None else None
        self.dtype = np_dtype(dtype) if dtype is not None else None
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.grad_req = grad_req if differentiable else "null"
        self.init = init
        self.allow_deferred_init = allow_deferred_init

    def __repr__(self):
        return "Parameter %s (shape=%s, dtype=%s)" % (self.name, self._shape,
                                                      self.dtype)

    # -- shape ------------------------------------------------------------
    @property
    def shape(self):
        return self._shape

    @shape.setter
    def shape(self, new_shape):
        new_shape = tuple(new_shape)
        if self._shape is not None and not (
                len(self._shape) == len(new_shape)
                and all(a == b or a in (0, -1)
                        for a, b in zip(self._shape, new_shape))):
            raise MXNetError("cannot update shape of %s from %s to %s"
                             % (self.name, self._shape, new_shape))
        self._shape = new_shape

    def _shape_known(self):
        return self._shape is not None and all(s > 0 for s in self._shape)

    # -- initialisation ---------------------------------------------------
    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        """Allocate and fill the data on ``ctx`` (default: the card), or
        wait for the first forward when the shape is not known yet and
        deferral is allowed."""
        default_init = default_init or _init_mod.Uniform()
        if self._data is not None and not force_reinit:
            return
        ctx = _ctx_list(ctx)
        if not self._shape_known():
            if self.allow_deferred_init:
                self._deferred_init = (init, ctx, default_init)
                return
            raise MXNetError(
                "cannot initialize Parameter %s because it has invalid "
                "shape %s; set allow_deferred_init=True or specify "
                "in_units/in_channels" % (self.name, self._shape))
        self._finish_init(init, ctx, default_init)

    def _finish_deferred_init(self):
        if not self._deferred_init:
            return
        init, ctx, default_init = self._deferred_init
        if not self._shape_known():
            raise DeferredInitializationError(
                "Parameter %s has unknown shape %s after the first forward"
                % (self.name, self._shape))
        self._deferred_init = ()
        self._finish_init(init, ctx, default_init)

    def _finish_init(self, init, ctx, default_init):
        """The Parameter's own initializer (a name or an object) fills
        it as a weight, whatever its name; else ``default_init``
        dispatches on the name (weight, bias, gamma...)."""
        explicit = init if init is not None else self.init
        data = nd_zeros(self._shape, ctx=ctx[0],
                        dtype=self.dtype or np.float32)
        desc = _init_mod.InitDesc(self.name)
        if explicit is not None:
            e = _init_mod.create(explicit)
            if isinstance(e, _init_mod.Initializer):
                e._init_weight(desc, data)
            else:
                e(desc, data)
        else:
            _init_mod.create(default_init)(desc, data)
        self._init_impl(data, ctx)

    def _init_impl(self, data: NDArray, ctx_list):
        if len(ctx_list) != 1:
            raise MXNetError("a Parameter on %d devices is not ported "
                             "(ROADMAP A15)" % len(ctx_list))
        self._data = [data.as_in_context(ctx_list[0])]
        self._init_grad()

    def _init_grad(self):
        if self.grad_req == "null":
            self._grad = None
            return
        for d in self._data:
            d.attach_grad(self.grad_req, stype=self._grad_stype)
        self._grad = [d.grad for d in self._data]

    # -- access -----------------------------------------------------------
    def _check_initialized(self):
        if self._data is None:
            if self._deferred_init:
                raise DeferredInitializationError(
                    "Parameter %s not initialized yet: the first forward "
                    "has not run" % self.name)
            raise MXNetError("Parameter %s has not been initialized; call "
                             ".initialize()" % self.name)

    def data(self, ctx=None) -> NDArray:
        self._check_initialized()
        if ctx is None or resolve(ctx) == self._data[0]._data.device:
            return self._data[0]
        raise MXNetError("Parameter %s is not initialized on %s"
                         % (self.name, ctx))

    def list_data(self) -> List[NDArray]:
        self._check_initialized()
        return list(self._data)

    def grad(self, ctx=None) -> NDArray:
        self._check_initialized()
        if self._grad is None:
            raise MXNetError("Parameter %s has grad_req='null'; no gradient"
                             % self.name)
        if ctx is None or resolve(ctx) == self._data[0]._data.device:
            return self._grad[0]
        raise MXNetError("no gradient of %s on %s" % (self.name, ctx))

    def list_grad(self) -> List[NDArray]:
        self._check_initialized()
        if self._grad is None:
            raise MXNetError("Parameter %s has grad_req='null'" % self.name)
        return list(self._grad)

    def list_ctx(self):
        if self._data is None and self._deferred_init:
            return [as_context(c) for c in self._deferred_init[1]]
        self._check_initialized()
        return [d.ctx for d in self._data]

    def zero_grad(self):
        for g in self._grad or ():
            if g.stype == "row_sparse":
                g._assign(g.retain([]))  # no rows stored
            else:
                g._data.zero_()

    def set_data(self, data):
        """Write ``data`` (an NDArray or array-like) into the
        Parameter in place, cast to its dtype; a deferred Parameter is
        initialized from it."""
        self.shape = tuple(data.shape)
        if self._data is None:
            if not self._deferred_init:
                raise MXNetError("Parameter %s not initialized" % self.name)
            _, ctx, _ = self._deferred_init
            self._deferred_init = ()
            src = data if isinstance(data, NDArray) else np.asarray(data)
            # a copy: the Parameter never shares the caller's array
            self._init_impl(nd_array(src, ctx=ctx[0], dtype=self.dtype),
                            ctx)
            return
        for d in self._data:
            src = data._data if isinstance(data, NDArray) else \
                nd_array(np.asarray(data), ctx=d.ctx)._data
            d._set_data(src.to(d._data.device))

    def reset_ctx(self, ctx):
        ctx = _ctx_list(ctx)
        if self._data is not None:
            self._init_impl(self._data[0].as_in_context(ctx[0]), ctx)
        elif self._deferred_init:
            init, _, default_init = self._deferred_init
            self._deferred_init = (init, ctx, default_init)

    def cast(self, dtype):
        self.dtype = np_dtype(dtype)
        if self._data is None:
            return
        self._data = [d.detach().astype(self.dtype) for d in self._data]
        self._init_grad()

    def var(self):
        """The Symbol variable of this Parameter (its name, and its
        shape and dtype where known); a running statistic without a
        gradient is an auxiliary state."""
        from ..symbol.symbol import Variable

        if self._var is None:
            self._var = Variable(self.name, shape=self._shape
                                 if self._shape_known() else None,
                                 dtype=self.dtype)
            if self.grad_req == "null" and self.name.endswith(
                    ("running_mean", "running_var", "moving_mean",
                     "moving_var")):
                self._var._outputs[0][0].is_aux = True
        return self._var


class Constant(Parameter):
    """A Parameter that is never learned, holding ``value``."""

    def __init__(self, name, value):
        if not isinstance(value, NDArray):
            value = np.asarray(value, dtype=np.float32)
        host = value.asnumpy() if isinstance(value, NDArray) else value
        self.value = value

        class _CInit(_init_mod.Initializer):
            def _init_weight(self, _, arr):
                _init_mod.Initializer._set(arr, host)

        super().__init__(name, grad_req="null", shape=host.shape,
                         dtype=host.dtype, init=_CInit())


class ParameterDict(object):
    """A dictionary of Parameters whose names share a prefix."""

    def __init__(self, prefix="", shared: Optional["ParameterDict"] = None):
        self._prefix = prefix
        self._params: "OrderedDict[str, Parameter]" = OrderedDict()
        self._shared = shared

    def __repr__(self):
        return "ParameterDict %s(%s)" % (self._prefix,
                                         ", ".join(self._params))

    def __getitem__(self, key) -> Parameter:
        return self._params[key]

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    @property
    def prefix(self):
        return self._prefix

    def _get_impl(self, name):
        if name in self._params:
            return self._params[name]
        if self._shared is not None and name in self._shared._params:
            self._params[name] = self._shared._params[name]
            return self._params[name]
        return None

    def get(self, name, **kwargs) -> Parameter:
        """The Parameter ``prefix + name``, made from ``kwargs`` when
        it does not exist yet; an existing one must agree with them
        (partial shapes merge)."""
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            param = Parameter(name, **kwargs)
            self._params[name] = param
            return param
        for k, v in kwargs.items():
            existing = getattr(param, k, None)
            if existing is None:
                setattr(param, k, v)
            elif k == "shape" and v is not None:
                v = (v,) if isinstance(v, int) else tuple(v)
                if len(v) != len(existing) or any(
                        a > 0 and b > 0 and a != b
                        for a, b in zip(existing, v)):
                    raise MXNetError(
                        "Parameter %r already has shape %s, inconsistent "
                        "with requested %s" % (name, existing, v))
                param._shape = tuple(a if a > 0 else b
                                     for a, b in zip(existing, v))
            elif k in ("dtype", "init", "grad_req") and v is not None \
                    and existing != v:
                raise MXNetError("Parameter %r already has %s=%r, "
                                 "inconsistent with requested %r"
                                 % (name, k, existing, v))
        return param

    def get_constant(self, name, value=None) -> Constant:
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            if value is None:
                raise MXNetError("no constant %r and no value given" % name)
            param = Constant(name, value)
            self._params[name] = param
        return param

    def update(self, other: "ParameterDict"):
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise MXNetError("duplicate parameter %r" % k)
            self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialize every Parameter on ``ctx`` (default: the card);
        ``init`` is the default initializer, dispatching by name."""
        init = init if init is not None else _init_mod.Uniform()
        for v in self.values():
            v.initialize(None, ctx, init, force_reinit=force_reinit)

    def zero_grad(self):
        for v in self.values():
            v.zero_grad()

    def reset_ctx(self, ctx):
        for v in self.values():
            v.reset_ctx(ctx)

    def setattr(self, name, value):
        for v in self.values():
            setattr(v, name, value)

    def save(self, filename, strip_prefix=""):
        from ..ndarray import save as nd_save

        arg_dict = {}
        for param in self.values():
            if not param.name.startswith(strip_prefix):
                raise MXNetError("prefix %r not in param name %r"
                                 % (strip_prefix, param.name))
            arg_dict[param.name[len(strip_prefix):]] = param.data()
        nd_save(filename, arg_dict)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        from ..ndarray import load as nd_load

        arg_dict = {restore_prefix + k: v
                    for k, v in nd_load(filename, ctx=ctx).items()}
        if not allow_missing:
            for name in self.keys():
                if name not in arg_dict:
                    raise MXNetError("parameter %r missing in file" % name)
        for name, val in arg_dict.items():
            if name not in self._params:
                if not ignore_extra:
                    raise MXNetError("parameter %r in file not in dict"
                                     % name)
                continue
            self._params[name].set_data(val)


def load_numpy(params, arrays: Dict[str, np.ndarray]):
    """Copy ``{name: numpy array}`` into the Parameters of ``params`` (a
    ParameterDict, such as ``block.collect_params()``) by name: every
    Parameter must have an array and every array a Parameter.  A
    deferred Parameter takes the array's shape and is initialized from
    it."""
    names = set(params.keys())
    missing, extra = names - set(arrays), set(arrays) - names
    if missing or extra:
        raise MXNetError("load_numpy: no array for %s; no parameter for %s"
                         % (sorted(missing)[:5], sorted(extra)[:5]))
    for name, p in params.items():
        p.set_data(np.asarray(arrays[name]))
