"""Optimizers of the PyTorch port.

Counterpart of part of ``mxtpu/optimizer/optimizer.py``: the
``Optimizer`` base (``lr``/``wd`` and their per-parameter multipliers,
an ``lr_scheduler``, ``rescale_grad``, ``clip_gradient``, the update
counts), ``SGD`` and ``Adam``, the ``Updater`` and ``get_updater``,
``create`` and ``register``, ``param_dict`` (gluon's Parameters, whose
``lr_mult``/``wd_mult`` win) and the Updater's ``get_states``/
``set_states``.  Each optimizer's per-parameter ``update``
runs its update op (``sgd_update``, ``sgd_mom_update``,
``adam_update``); its ``fused_update_multi`` does the same arithmetic
over every parameter at once with ``torch._foreach_*`` (the JAX
package's one jitted call).

``make_scan_step`` gives the whole-tree step that
``mxtpu_torch.fused_train.FusedTrainLoop`` runs K times a call: a
:class:`ScanStep` whose ``step`` updates the weights and states in place
and reads each step's learning rates from a device tensor row (so that a
captured CUDA graph reads new rates on every replay), and whose
``host_sched`` computes those rows up front on the host, scheduler and
Adam's bias correction included, without touching a counter.

Multi-precision is not ported (ROADMAP A10c): ``multi_precision=True``
with a low-precision weight raises.  The other optimizers and sparse
gradients are not ported either.
"""
from __future__ import annotations

import math
import pickle
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..base import MXNetError
from ..ndarray.ndarray import array, imperative_invoke, zeros

__all__ = ["Optimizer", "SGD", "Adam", "ScanStep", "Updater", "get_updater",
           "create", "register"]

_LOWP = (torch.float16, torch.bfloat16)


class Optimizer(object):
    opt_registry: Dict[str, type] = {}

    @staticmethod
    def register(klass):
        Optimizer.opt_registry[klass.__name__.lower()] = klass
        return klass

    @staticmethod
    def create_optimizer(name, **kwargs):
        if name.lower() not in Optimizer.opt_registry:
            raise MXNetError("unknown optimizer %r" % name)
        return Optimizer.opt_registry[name.lower()](**kwargs)

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.lr_mult: Dict[Any, float] = {}
        self.wd_mult: Dict[Any, float] = {}
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count: Dict[Any, int] = {}
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        self.idx2name = dict(param_idx2name or {})
        # index -> gluon Parameter, whose lr_mult and wd_mult win
        self.param_dict = param_dict or {}
        self.sym_info = ()
        if sym is not None:
            self.sym_info = (sym.attr_dict(), sym.list_arguments())
        self.set_lr_mult({})
        self.set_wd_mult({})

    def create_state(self, index, weight):
        return None

    def create_state_multi_precision(self, index, weight):
        """The plain ``create_state``: a float32 master copy for a
        low-precision weight is not ported."""
        if self.multi_precision and weight._data.dtype in _LOWP:
            raise MXNetError("multi_precision for a %s weight is not ported "
                             "(ROADMAP A10c)" % weight.dtype)
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def fused_update_multi(self, indices, weights, grads, states) -> bool:
        """Update many parameters at once; False when this optimizer has
        no such path (the caller updates one by one)."""
        return False

    def make_scan_step(self, indices, weights) -> Optional["ScanStep"]:
        """The whole-tree step of a fused multi-step training loop, or
        None when this optimizer has no such form."""
        return None

    def _sched_counts(self, indices, k_steps):
        """(per-index counts, num_update) after each of ``k_steps``
        whole-tree updates, without touching the real counters."""
        counts = dict(self._index_update_count)
        num_update = self.num_update
        out = []
        for _ in range(k_steps):
            for idx in indices:
                c = counts.get(idx, self.begin_num_update) + 1
                counts[idx] = c
                num_update = max(c, num_update)
            out.append((dict(counts), num_update))
        return out

    def commit_scan_steps(self, indices, k_steps):
        """Advance the real counters by ``k_steps`` whole-tree updates."""
        for _ in range(k_steps):
            self._update_count(list(indices))

    def _base_lr(self, num_update):
        return self.lr_scheduler(num_update) \
            if self.lr_scheduler is not None else self.lr

    # -- bookkeeping ------------------------------------------------------
    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise MXNetError("lr_scheduler is set; cannot set lr directly")
        self.lr = lr

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = {}
        if self.sym_info:
            attrs, arg_names = self.sym_info
            for name in arg_names:
                if name in attrs and "__lr_mult__" in attrs[name]:
                    self.lr_mult[name] = float(attrs[name]["__lr_mult__"])
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        # no weight decay on what is not a weight or a gamma
        self.wd_mult = {n: 0.0 for n in self.idx2name.values()
                        if not (n.endswith("_weight") or n.endswith("_gamma"))}
        if self.sym_info:
            attrs, arg_names = self.sym_info
            for name in arg_names:
                if name in attrs and "__wd_mult__" in attrs[name]:
                    self.wd_mult[name] = float(attrs[name]["__wd_mult__"])
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        for idx in index if isinstance(index, (list, tuple)) else [index]:
            if idx not in self._index_update_count:
                self._index_update_count[idx] = self.begin_num_update
            self._index_update_count[idx] += 1
            self.num_update = max(self._index_update_count[idx],
                                  self.num_update)

    def _get_lr_mult(self, index):
        if index in self.param_dict:
            return self.param_dict[index].lr_mult
        if index in self.lr_mult:
            return self.lr_mult[index]
        if index in self.idx2name:
            return self.lr_mult.get(self.idx2name[index], 1.0)
        return 1.0

    def _get_lr(self, index):
        return self._base_lr(self.num_update) * self._get_lr_mult(index)

    def _get_wd(self, index):
        wd = self.wd
        if index in self.param_dict:
            wd *= self.param_dict[index].wd_mult
        elif index in self.wd_mult:
            wd *= self.wd_mult[index]
        elif index in self.idx2name:
            wd *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wd

    def _common_kwargs(self):
        kw = {"rescale_grad": self.rescale_grad}
        if self.clip_gradient is not None:
            kw["clip_gradient"] = self.clip_gradient
        return kw

    @staticmethod
    def _apply(op_name, weight, grad, states, **attrs):
        """Run an update op and write its results back in place."""
        outs = imperative_invoke(op_name, weight, grad, *states, **attrs)
        weight._set_data(outs[0])
        for st, new in zip(states, outs[1:]):
            st._set_data(new)


register = Optimizer.register
create = Optimizer.create_optimizer


class ScanStep(object):
    """The whole-tree optimizer step of a fused multi-step training loop
    (``mxtpu_torch/fused_train.py``; the JAX package's ``ScanStep``).

    * ``pack_states(state_objs)`` -> the state tensors ``step`` updates
      (the updater's own, so nothing is written back after a call);
    * ``step(w, s, g, lr_row, groups=None)`` updates the weight tensors
      ``w`` and the states ``s`` in place from the gradients ``g``;
      ``lr_row`` is this step's (n,) float32 tensor of effective rates
      on the weights' device, read on the device, never on the host.
      ``groups`` partitions the n positions into tuples whose rates are
      equal (``lr_groups``); each tuple is scaled by one element of the
      row in one ``torch._foreach_mul_`` (None: each alone);
    * ``host_sched(k)`` -> np.float32 (k, n): the effective rates of the
      next k whole-tree steps (scheduler and bias correction included),
      with no counter changed.
    """

    def __init__(self, pack_states, step, host_sched):
        self.pack_states = pack_states
        self.step = step
        self.host_sched = host_sched


def lr_groups(rows: np.ndarray):
    """The columns of (k, n) rate rows, grouped where they are equal in
    every row (first appearance first)."""
    cols: Dict[bytes, List[int]] = {}
    for j in range(rows.shape[1]):
        cols.setdefault(rows[:, j].tobytes(), []).append(j)
    return [tuple(g) for g in cols.values()]


def _scale_by_row(ts, lr_row, groups):
    """ts[j] *= lr_row[j], one foreach call per group of equal rates."""
    for grp in groups or [(j,) for j in range(len(ts))]:
        torch._foreach_mul_([ts[j] for j in grp], lr_row[grp[0]])


def _scaled_grads(opt, grads, w, wds):
    """``clip(rescale * g) + wd * w`` for every parameter (new tensors)."""
    g = torch._foreach_mul(grads, opt.rescale_grad)
    if opt.clip_gradient is not None and opt.clip_gradient >= 0:
        torch._foreach_clamp_min_(g, -opt.clip_gradient)
        torch._foreach_clamp_max_(g, opt.clip_gradient)
    if any(wds):
        torch._foreach_add_(g, torch._foreach_mul(w, wds))
    return g


@register
class SGD(Optimizer):
    """SGD with momentum: ``g = clip(rescale * grad)``, ``mom = momentum
    * mom - lr * (g + wd * w)``, ``w += mom`` (``w -= lr * (g + wd * w)``
    without momentum)."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return zeros(weight.shape, ctx=weight.ctx, dtype=weight.dtype)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        kw = self._common_kwargs()
        if state is None:
            self._apply("sgd_update", weight, grad, (), lr=lr, wd=wd, **kw)
        else:
            self._apply("sgd_mom_update", weight, grad, (state,), lr=lr,
                        wd=wd, momentum=self.momentum, **kw)

    def _foreach_step(self, w, mom, grads, wds, scale_lr):
        """``mom = momentum * mom - lr * (g + wd * w)``, ``w += mom``
        (``w -= lr * (g + wd * w)`` without momentum), in place;
        ``scale_lr`` multiplies a tensor list by the rates."""
        with torch.no_grad():
            g = _scaled_grads(self, grads, w, wds)
            scale_lr(g)
            if self.momentum != 0.0:
                torch._foreach_mul_(mom, self.momentum)
                torch._foreach_sub_(mom, g)
                torch._foreach_add_(w, mom)
            else:
                torch._foreach_sub_(w, g)

    def fused_update_multi(self, indices, weights, grads, states) -> bool:
        """The per-parameter arithmetic of ``update``, over every
        parameter in one sequence of ``torch._foreach_*`` calls."""
        for i in indices:
            self._update_count(i)
        lrs = [self._get_lr(i) for i in indices]
        wds = [self._get_wd(i) for i in indices]
        mom = [s._data for s in states] if self.momentum != 0.0 else []
        self._foreach_step([x._data for x in weights], mom,
                           [x._data for x in grads], wds,
                           lambda g: torch._foreach_mul_(g, lrs))
        return True

    def make_scan_step(self, indices, weights):
        if self.multi_precision and any(w._data.dtype in _LOWP
                                           for w in weights):
            return None
        indices = list(indices)
        wds = [self._get_wd(i) for i in indices]
        has_state = self.momentum != 0.0

        def pack_states(state_objs):
            return [s._data for s in state_objs] if has_state else []

        def step(w, s, g, lr_row, groups=None):
            self._foreach_step(w, s, g, wds, lambda t: _scale_by_row(
                t, lr_row, groups))

        def host_sched(k_steps):
            out = np.empty((k_steps, len(indices)), np.float32)
            for k, (_, num_update) in enumerate(
                    self._sched_counts(indices, k_steps)):
                base = self._base_lr(num_update)
                for j, idx in enumerate(indices):
                    out[k, j] = base * self._get_lr_mult(idx)
            return out

        return ScanStep(pack_states, step, host_sched)


@register
class Adam(Optimizer):
    """Adam with the bias correction folded into the rate: at the
    parameter's t-th update ``lr_t = lr * sqrt(1 - beta2^t) / (1 -
    beta1^t)``, ``g = clip(rescale * grad) + wd * w``, ``m = beta1 * m +
    (1 - beta1) * g``, ``v = beta2 * v + (1 - beta2) * g^2``, ``w -= lr_t
    * m / (sqrt(v) + epsilon)`` (the ``adam_update`` op)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return (zeros(weight.shape, ctx=weight.ctx, dtype=weight.dtype),
                zeros(weight.shape, ctx=weight.ctx, dtype=weight.dtype))

    def _corrected(self, lr, t):
        return lr * math.sqrt(1.0 - self.beta2 ** t) / (1.0 - self.beta1 ** t)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._corrected(self._get_lr(index),
                             self._index_update_count[index])
        self._apply("adam_update", weight, grad, state, lr=lr,
                    wd=self._get_wd(index), beta1=self.beta1,
                    beta2=self.beta2, epsilon=self.epsilon,
                    **self._common_kwargs())

    def _foreach_step(self, w, means, variances, grads, wds, scale_lr):
        with torch.no_grad():
            g = _scaled_grads(self, grads, w, wds)
            torch._foreach_mul_(means, self.beta1)
            torch._foreach_add_(means, g, alpha=1.0 - self.beta1)
            torch._foreach_mul_(variances, self.beta2)
            torch._foreach_addcmul_(variances, g, g, value=1.0 - self.beta2)
            denom = torch._foreach_sqrt(variances)
            torch._foreach_add_(denom, self.epsilon)
            upd = torch._foreach_div(means, denom)
            scale_lr(upd)
            torch._foreach_sub_(w, upd)

    def fused_update_multi(self, indices, weights, grads, states) -> bool:
        if self.multi_precision:
            return False
        for i in indices:
            self._update_count(i)
        lrs = [self._corrected(self._get_lr(i), self._index_update_count[i])
               for i in indices]
        self._foreach_step([x._data for x in weights],
                           [s[0]._data for s in states],
                           [s[1]._data for s in states],
                           [x._data for x in grads],
                           [self._get_wd(i) for i in indices],
                           lambda u: torch._foreach_mul_(u, lrs))
        return True

    def make_scan_step(self, indices, weights):
        if self.multi_precision:
            return None
        indices = list(indices)
        wds = [self._get_wd(i) for i in indices]

        def pack_states(state_objs):
            return ([s[0]._data for s in state_objs],
                    [s[1]._data for s in state_objs])

        def step(w, s, g, lr_row, groups=None):
            self._foreach_step(w, s[0], s[1], g, wds, lambda u: _scale_by_row(
                u, lr_row, groups))

        def host_sched(k_steps):
            # the bias correction folded into the rate, with the count t
            # each parameter would have at that step, as ``update`` does
            out = np.empty((k_steps, len(indices)), np.float32)
            for k, (counts, num_update) in enumerate(
                    self._sched_counts(indices, k_steps)):
                base = self._base_lr(num_update)
                for j, idx in enumerate(indices):
                    out[k, j] = self._corrected(
                        base * self._get_lr_mult(idx), counts[idx])
            return out

        return ScanStep(pack_states, step, host_sched)


class Updater(object):
    """Holds each parameter's optimizer state and applies updates."""

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states: Dict[Any, Any] = {}

    def _state(self, index, weight):
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
        return self.states[index]

    def __call__(self, index, grad, weight):
        self.optimizer.update(index, weight, grad, self._state(index, weight))

    def update_multi(self, triples):
        """Update many parameters, ``triples`` of (index, grad, weight):
        at once where the optimizer can, else one by one."""
        states = [self._state(i, w) for i, _, w in triples]
        if len(triples) > 1 and self.optimizer.fused_update_multi(
                [t[0] for t in triples], [t[2] for t in triples],
                [t[1] for t in triples], states):
            return
        for (idx, g, w), st in zip(triples, states):
            self.optimizer.update(idx, w, g, st)

    def get_states(self, dump_optimizer=False) -> bytes:
        """The states (as host arrays) and, with ``dump_optimizer``, the
        update counters, pickled (the reference's ``get_states``)."""
        opt_state = None
        if dump_optimizer:
            opt_state = {
                "num_update": self.optimizer.num_update,
                "begin_num_update": self.optimizer.begin_num_update,
                "_index_update_count": dict(
                    self.optimizer._index_update_count)}
        host = {i: _map_state(st, lambda a: a.asnumpy())
                for i, st in self.states.items()}
        return pickle.dumps((host, opt_state))

    def set_states(self, states, ctx=None):
        """Restore what ``get_states`` wrote onto ``ctx`` (default: the
        card)."""
        host, opt_state = pickle.loads(states) \
            if isinstance(states, bytes) else states
        self.states = {i: _map_state(st, lambda a: array(a, ctx=ctx))
                       for i, st in host.items()}
        if opt_state is not None:
            self.optimizer.__dict__.update(opt_state)


def _map_state(state, fn):
    """``fn`` over the arrays of one parameter's state (None, an array,
    or a tuple of them)."""
    if state is None:
        return None
    if isinstance(state, (tuple, list)):
        return tuple(_map_state(s, fn) for s in state)
    return fn(state)


def get_updater(optimizer: Optimizer) -> Updater:
    return Updater(optimizer)
