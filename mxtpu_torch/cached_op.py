"""CachedOp of the PyTorch port: a traced graph run as one call.

Counterpart of ``mxtpu/cached_op.py``, which gluon's ``hybridize()``
builds from the traced Symbol.  The JAX package jits the graph and,
under ``autograd.record()``, tapes the whole call as one node through
``jax.vjp``.  Here the graph is the executor's walk
(``executor._build_graph_fn``): run with grad enabled under
``record()``, the torch graph it leaves is that one node, reaching the
Parameters' leaf tensors, so ``backward`` needs nothing of the
CachedOp.

* Inputs are every graph argument, in ``list_arguments()`` order, and
  the aux states (BatchNorm's moving stats), whose arrays are read anew
  on every call: ``autograd.mark_variables`` may have replaced an
  array's tensor since the last one.
* Training (``autograd.is_training()``): the moving stats are folded
  with the batch statistics and written back into the aux arrays in
  place, under ``no_grad``; in training BatchNorm reads them for nothing
  else, so no saved tensor of the recorded graph is touched.
* The AMP compute dtype is the one set when the CachedOp was made, as
  in the JAX package; random ops draw from the device's generator
  (``mxtpu_torch.random``).
* float32 convolutions and products on the card run with TF32 off,
  as everywhere (``ops.registry.float32_numerics``).

The AOT ``warmup``, the shape buckets and their pad masks,
``call_fused`` and the inspect/health/perf/profiler hooks are not
ported (ROADMAP A10b, A17, A18).
"""
from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch

from . import amp as _amp
from . import autograd as _ag
from .base import MXNetError
from .executor import _build_graph_fn
from .ndarray.ndarray import NDArray
from .symbol.symbol import Symbol

__all__ = ["CachedOp"]

# hybridize() flags of the reference that change nothing here: torch
# allocates per call, and the graph takes any shape
_NO_ANALOG_FLAGS = ("static_alloc", "static_shape")


class CachedOp(object):
    """A callable graph: ``op(args, aux_arrays)`` -> output NDArrays."""

    def __init__(self, sym: Symbol, flags: Sequence[Tuple[str, Any]] = ()):
        self._symbol = sym
        self._flags = dict(flags)
        for flag in self._flags:
            if flag not in _NO_ANALOG_FLAGS:
                raise MXNetError("CachedOp flag %r is not ported (ROADMAP "
                                 "A10b)" % flag)
        self._arg_names = sym.list_arguments()
        self._aux_names = sym.list_auxiliary_states()
        self._n_outputs = len(sym.list_outputs())
        self._amp_dtype = _amp.get_compute_dtype()
        # (device, is_train) -> the graph walk
        self._fns: Dict[Tuple[torch.device, bool], Any] = {}

    @property
    def symbol(self) -> Symbol:
        return self._symbol

    def _graph_fn(self, device, is_train):
        key = (device, is_train)
        fn = self._fns.get(key)
        if fn is None:
            fn = self._fns[key] = _build_graph_fn(
                self._symbol, self._arg_names, self._aux_names, is_train,
                device, self._amp_dtype)
        return fn

    def __call__(self, args: Sequence[NDArray],
                 aux_arrays: Sequence[NDArray] = ()):
        if len(args) != len(self._arg_names):
            raise MXNetError("CachedOp expects %d args (%s), got %d"
                             % (len(self._arg_names), self._arg_names,
                                len(args)))
        if len(aux_arrays) != len(self._aux_names):
            raise MXNetError("CachedOp expects %d aux arrays, got %d"
                             % (len(self._aux_names), len(aux_arrays)))
        device = args[0]._data.device
        training = _ag.is_training()
        fn = self._graph_fn(device, training)
        with torch.set_grad_enabled(_ag.is_recording()):
            outs, aux_new = fn([a._data for a in args],
                               [a._data for a in aux_arrays])
        if training:
            for arr, new in zip(aux_arrays, aux_new):
                if new is not arr._data:
                    arr._set_data(new)
        return [NDArray(o) for o in outs]
