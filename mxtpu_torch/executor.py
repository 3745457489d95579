"""Executor of the PyTorch port: a bound Symbol, and rematerialization.

Counterpart of ``mxtpu/executor.py``.

The executor runs the graph node by node in topological order
(``_build_graph_fn``), each op a torch call, ``is_train`` passed to the
train-aware ops, and the BatchNorm moving stats folded in training as
``m * old + (1 - m) * batch`` (the batch's biased variance; no gradient
flows into them).  The AMP policy (``mxtpu_torch/amp.py``) set when the
executor is bound is kept (``_amp_dtype``) and applied to each node's
inputs in the walk (``amp.cast_op_inputs``), where the JAX package
applies it.  ``forward(is_train=True)`` runs under
``torch.enable_grad()`` with the arguments whose ``grad_req`` is not
``null`` as leaves and keeps the graph; ``backward()`` seeds the heads
with ones (or the given ``out_grads``), asks torch for the leaves'
gradients and writes them into the gradient arrays (``write``) or adds
them (``add``).  Arguments, aux states and gradients are written in
place, so a Module's arrays and the executor's stay shared.  Each op
that calls cuDNN or cuBLAS turns TF32 off for a float32 input on the
card (``ops.registry.float32_numerics``): float32 means float32, as in
the JAX package.

``MXNET_BACKWARD_DO_MIRROR`` (or ``MXTPU_...``) wraps the training
graph in :func:`apply_remat` under ``MXTPU_REMAT_POLICY`` (default
``full``).  The graph passes, the inspect/health/perf/profiler hooks
and bucketed dispatch are not ported.

Remat: ``jax.checkpoint`` with a policy becomes
:func:`torch.utils.checkpoint.checkpoint` (non-reentrant) with a
selective-checkpoint policy: during the forward the policy marks
each ATen op's output as saved or as recomputed in the backward.

* ``"dots"`` (``dots_saveable``): the outputs of the matrix products are
  saved; everything else is recomputed.
* ``"dots_no_batch"`` (``dots_with_no_batch_dims_saveable``): only the
  products without a batch dimension are saved (``bmm`` is recomputed).
* ``"full"``: nothing is saved; the whole function is recomputed from
  its inputs.

Remat changes memory and recomputation, never values.  A hand-written
kernel launched through ctypes is not an ATen op: the policy never sees
it, so its ``torch.autograd.Function`` forward runs again in the
recompute (as ``dots_saveable`` does not save a Pallas call's outputs).
"""
from __future__ import annotations

import functools
import os
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from . import amp as _amp
from .base import MXNetError, torch_dtype
from .context import resolve
from .ndarray.ndarray import NDArray
from .ops import registry as _reg
from .symbol.symbol import Symbol, _topo_order

__all__ = ["Executor", "apply_remat"]

_BN_OPS = {"BatchNorm", "BatchNorm_v1"}

_aten = torch.ops.aten
_UNBATCHED = frozenset({_aten.mm.default, _aten.mm.dtype,
                        _aten.addmm.default})
_REMAT_POLICIES = {
    # the ATen ops whose outputs each policy saves
    "dots": _UNBATCHED | {_aten.bmm.default},
    "dots_no_batch": _UNBATCHED,
    "full": frozenset(),
}


def _policy(saveable):
    """The selective-checkpoint policy that saves the outputs of the ops
    in ``saveable`` and recomputes the rest."""
    def policy(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in saveable \
            else CheckpointPolicy.PREFER_RECOMPUTE
    return policy


def apply_remat(fn, policy_name):
    """``fn`` wrapped so that a differentiated call saves only what the
    named policy keeps ('full' = nothing, 'dots' = product outputs,
    'dots_no_batch' = unbatched product outputs) and recomputes the rest
    in the backward."""
    if policy_name not in _REMAT_POLICIES:
        raise MXNetError("remat policy must be one of %s (got %r)"
                         % (sorted(_REMAT_POLICIES), policy_name))
    saveable = _REMAT_POLICIES[policy_name]

    @functools.wraps(fn)
    def remat(*args):
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=lambda: create_selective_checkpoint_contexts(
                              _policy(saveable)))
    return remat


def _maybe_remat(fn):
    """The training graph fn under :func:`apply_remat` when
    MXNET_BACKWARD_DO_MIRROR / MXTPU_BACKWARD_DO_MIRROR is set, with the
    policy of MXTPU_REMAT_POLICY ('full' by default)."""
    flag = os.environ.get("MXTPU_BACKWARD_DO_MIRROR",
                          os.environ.get("MXNET_BACKWARD_DO_MIRROR", "0"))
    if flag not in ("1", "true", "True"):
        return fn
    return apply_remat(fn, os.environ.get("MXTPU_REMAT_POLICY", "full"))


def _build_graph_fn(symbol: Symbol, arg_names: List[str],
                    aux_names: List[str], is_train: bool, device,
                    compute_dtype: Optional[str] = None):
    """fn(arg_vals, aux_vals) -> (outputs, new_aux_vals), a walk of the
    graph in topological order; with ``compute_dtype`` each node's inputs
    are cast by the AMP policy first."""
    from . import random as _rnd

    nodes = _topo_order(symbol._outputs)
    arg_pos = {n: i for i, n in enumerate(arg_names)}
    aux_pos = {n: i for i, n in enumerate(aux_names)}

    def graph_fn(arg_vals, aux_vals):
        env = {}
        aux_new = list(aux_vals)
        for node in nodes:
            if node.is_variable:
                env[(id(node), 0)] = aux_vals[aux_pos[node.name]] \
                    if node.is_aux else arg_vals[arg_pos[node.name]]
                continue
            invals = [env[(id(inode), idx)] for inode, idx in node.inputs]
            if compute_dtype is not None:
                invals = _amp.cast_op_inputs(node.op.name, invals,
                                             compute_dtype)
            attrs = dict(node.attrs)
            if node.op.train_aware:
                attrs["is_train"] = is_train
            if not invals:
                attrs["device"] = device
            gen = _rnd.generator(device) if node.op.needs_rng else None
            out = _reg.invoke(node.op, invals, attrs, gen)
            for i, o in enumerate(out):
                env[(id(node), i)] = o
            # BatchNorm: fold the batch stats into the moving stats
            if is_train and node.op.name in _BN_OPS \
                    and not attrs.get("use_global_stats", False):
                m = float(attrs.get("momentum", 0.9))
                for (aux_node, _), stat in zip(node.inputs[3:5], out[1:3]):
                    if aux_node.is_variable and aux_node.is_aux:
                        p = aux_pos[aux_node.name]
                        aux_new[p] = m * aux_new[p] + (1.0 - m) * stat.detach()
        return [env[(id(n), i)] for n, i in symbol._outputs], aux_new

    return _maybe_remat(graph_fn) if is_train else graph_fn


class Executor(object):
    """A Symbol bound to arrays on one device."""

    def __init__(self, symbol: Symbol, ctx, arg_arrays: List[NDArray],
                 grad_arrays: List[Optional[NDArray]], grad_req: List[str],
                 aux_arrays: List[NDArray]):
        self._symbol = symbol
        self._ctx = resolve(ctx)
        self._arg_names = symbol.list_arguments()
        self._aux_names = symbol.list_auxiliary_states()
        self.arg_arrays = arg_arrays
        self.grad_arrays = grad_arrays
        self._grad_req = grad_req
        self.aux_arrays = aux_arrays
        self.arg_dict = dict(zip(self._arg_names, arg_arrays))
        self.grad_dict = dict(zip(self._arg_names, grad_arrays))
        self.aux_dict = dict(zip(self._aux_names, aux_arrays))
        self.outputs: List[NDArray] = []
        self._diff_idx = [i for i, r in enumerate(grad_req) if r != "null"]
        self._has_rng = any(not n.is_variable and n.op.needs_rng
                            for n in _topo_order(symbol._outputs))
        # the AMP policy of the bind, which every graph fn of this
        # executor (and a FusedTrainLoop over it) keeps
        self._amp_dtype = _amp.get_compute_dtype()
        self._infer_fn = _build_graph_fn(symbol, self._arg_names,
                                         self._aux_names, False, self._ctx,
                                         self._amp_dtype)
        self._train_fn = _build_graph_fn(symbol, self._arg_names,
                                         self._aux_names, True, self._ctx,
                                         self._amp_dtype)
        # (leaf tensors, output tensors) of the last forward(is_train=True)
        self._pending = None

    # -- binding entry points --------------------------------------------
    @staticmethod
    def _normalize_grad_req(grad_req, arg_names: List[str]) -> List[str]:
        if isinstance(grad_req, str):
            return [grad_req] * len(arg_names)
        if isinstance(grad_req, (list, tuple)):
            return list(grad_req)
        if isinstance(grad_req, dict):
            return [grad_req.get(n, "null") for n in arg_names]
        raise MXNetError("bad grad_req %r" % (grad_req,))

    @staticmethod
    def _simple_bind(symbol: Symbol, ctx, grad_req, type_dict, shape_kwargs):
        dev = resolve(ctx)
        arg_names = symbol.list_arguments()
        arg_shapes, _, aux_shapes = symbol.infer_shape(**shape_kwargs)
        type_dict = type_dict or {}
        arg_arrays = [NDArray(torch.zeros(shape, device=dev, dtype=torch_dtype(
            type_dict.get(name, np.float32))))
            for name, shape in zip(arg_names, arg_shapes)]
        reqs = Executor._normalize_grad_req(grad_req, arg_names)
        # the inputs whose shapes the caller gave get no gradient
        for i, name in enumerate(arg_names):
            if name in shape_kwargs and isinstance(grad_req, str):
                reqs[i] = "null"
        grad_arrays = [NDArray(torch.zeros_like(a._data)) if r != "null"
                       else None for a, r in zip(arg_arrays, reqs)]
        aux_arrays = [NDArray(torch.zeros(s, device=dev)) for s in aux_shapes]
        return Executor(symbol, dev, arg_arrays, grad_arrays, reqs,
                        aux_arrays)

    @staticmethod
    def _bind(symbol: Symbol, ctx, args, args_grad, grad_req, aux_states):
        dev = resolve(ctx)
        arg_names = symbol.list_arguments()
        aux_names = symbol.list_auxiliary_states()
        arg_arrays = [args[n] for n in arg_names] if isinstance(args, dict) \
            else list(args or [])
        if len(arg_arrays) != len(arg_names):
            raise MXNetError("bind: expected %d args, got %d"
                             % (len(arg_names), len(arg_arrays)))
        reqs = Executor._normalize_grad_req(grad_req, arg_names)
        if args_grad is None:
            grad_arrays = [None] * len(arg_names)
            reqs = ["null"] * len(arg_names)
        elif isinstance(args_grad, dict):
            grad_arrays = [args_grad.get(n) for n in arg_names]
            reqs = [r if g is not None else "null"
                    for r, g in zip(reqs, grad_arrays)]
        else:
            grad_arrays = list(args_grad)
        if aux_states is None:
            _, _, aux_shapes = symbol.infer_shape(
                **{n: a.shape for n, a in zip(arg_names, arg_arrays)})
            aux_arrays = [NDArray(torch.zeros(s, device=dev))
                          for s in aux_shapes]
        elif isinstance(aux_states, dict):
            aux_arrays = [aux_states[n] for n in aux_names]
        else:
            aux_arrays = list(aux_states)
        return Executor(symbol, dev, arg_arrays, grad_arrays, reqs,
                        aux_arrays)

    # -- execution --------------------------------------------------------
    def forward(self, is_train: bool = False, **kwargs):
        """Run the graph; ``kwargs`` are written into the named
        arguments first.  With ``is_train`` and arguments that want a
        gradient, the graph is kept for ``backward``."""
        for name, val in kwargs.items():
            if name not in self.arg_dict:
                raise MXNetError("unknown argument %r" % name)
            src = val if isinstance(val, NDArray) else NDArray(
                torch.as_tensor(np.asarray(val)))
            dst = self.arg_dict[name]
            if src.shape != dst.shape:
                raise MXNetError("shape mismatch for %r: %s vs bound %s"
                                 % (name, src.shape, dst.shape))
            dst._set_data(src._data)
        aux_vals = [a._data for a in self.aux_arrays]
        if is_train and self._diff_idx:
            vals = [a._data for a in self.arg_arrays]
            leaves = []
            for i in self._diff_idx:
                vals[i] = vals[i].detach().requires_grad_(True)
                leaves.append(vals[i])
            with torch.enable_grad():
                outs, aux_new = self._train_fn(vals, aux_vals)
            self._pending = (leaves, outs)
        else:
            fn = self._train_fn if is_train else self._infer_fn
            with torch.no_grad():
                outs, aux_new = fn([a._data for a in self.arg_arrays],
                                   aux_vals)
            self._pending = None
        if is_train:
            self._write_aux(aux_new)
        self.outputs = [NDArray(o.detach()) for o in outs]
        return self.outputs

    def backward(self, out_grads=None):
        """Write (or add) the gradients of the last training forward's
        outputs, seeded with ``out_grads`` or ones."""
        if not self._diff_idx:
            return
        if self._pending is None:
            raise MXNetError("backward() before forward(is_train=True)")
        leaves, outs = self._pending
        self._pending = None
        if out_grads is None:
            ograds = [torch.ones_like(o) for o in outs]
        else:
            if isinstance(out_grads, NDArray):
                out_grads = [out_grads]
            ograds = [g._data for g in out_grads]
        grads = torch.autograd.grad(outs, leaves, ograds, allow_unused=True)
        with torch.no_grad():
            for i, g in zip(self._diff_idx, grads):
                garr = self.grad_arrays[i]
                if garr is None:
                    continue
                if g is None:  # the output does not depend on it
                    g = torch.zeros_like(garr._data)
                if self._grad_req[i] == "add":
                    garr._data.add_(g)
                else:
                    garr._data.copy_(g)

    def _write_aux(self, aux_new):
        for arr, val in zip(self.aux_arrays, aux_new):
            if val is not arr._data:
                arr._set_data(val)

    # -- utilities --------------------------------------------------------
    def copy_params_from(self, arg_params: Dict[str, NDArray],
                         aux_params: Optional[Dict[str, NDArray]] = None,
                         allow_extra_params: bool = False):
        for name, arr in (arg_params or {}).items():
            if name in self.arg_dict:
                arr.copyto(self.arg_dict[name])
            elif not allow_extra_params:
                raise MXNetError("unknown arg param %r" % name)
        for name, arr in (aux_params or {}).items():
            if name in self.aux_dict:
                arr.copyto(self.aux_dict[name])
            elif not allow_extra_params:
                raise MXNetError("unknown aux param %r" % name)