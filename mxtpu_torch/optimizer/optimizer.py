"""Optimizers of the PyTorch port.

Counterpart of part of ``mxtpu/optimizer/optimizer.py``: the
``Optimizer`` base (``lr``/``wd`` and their per-parameter multipliers,
``rescale_grad``, ``clip_gradient``, the update counts), ``SGD``, the
``Updater`` and ``get_updater``, ``create`` and ``register``.  SGD's
per-parameter ``update`` runs the ``sgd_update``/``sgd_mom_update`` ops;
its ``fused_update_multi`` does the same arithmetic over every parameter
at once with ``torch._foreach_*`` (the JAX package's one jitted call).
Other optimizers, lr schedulers, multi-precision and sparse gradients
are not ported.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..base import MXNetError
from ..ndarray.ndarray import imperative_invoke, zeros

__all__ = ["Optimizer", "SGD", "Updater", "get_updater", "create",
           "register"]


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
                 clip_gradient=None, learning_rate=0.01, sym=None,
                 begin_num_update=0):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.wd = wd
        self.lr_mult: Dict[Any, float] = {}
        self.wd_mult: Dict[Any, float] = {}
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count: Dict[Any, int] = {}
        self.clip_gradient = clip_gradient
        self.idx2name = dict(param_idx2name or {})
        self.sym_info = ()
        if sym is not None:
            self.sym_info = (sym.attr_dict(), sym.list_arguments())
        self.set_lr_mult({})
        self.set_wd_mult({})

    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def fused_update_multi(self, indices, weights, grads, states) -> bool:
        """Update many parameters at once; False when this optimizer has
        no such path (the caller updates one by one)."""
        return False

    # -- bookkeeping ------------------------------------------------------
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
        if index in self.lr_mult:
            return self.lr_mult[index]
        if index in self.idx2name:
            return self.lr_mult.get(self.idx2name[index], 1.0)
        return 1.0

    def _get_lr(self, index):
        return self.lr * self._get_lr_mult(index)

    def _get_wd(self, index):
        wd = self.wd
        if index in self.wd_mult:
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

    def fused_update_multi(self, indices, weights, grads, states) -> bool:
        """The per-parameter arithmetic of ``update``, over every
        parameter in one sequence of ``torch._foreach_*`` calls."""
        for i in indices:
            self._update_count(i)
        lrs = [self._get_lr(i) for i in indices]
        wds = [self._get_wd(i) for i in indices]
        w = [x._data for x in weights]
        with torch.no_grad():
            g = torch._foreach_mul([x._data for x in grads],
                                   self.rescale_grad)
            if self.clip_gradient is not None and self.clip_gradient >= 0:
                torch._foreach_clamp_min_(g, -self.clip_gradient)
                torch._foreach_clamp_max_(g, self.clip_gradient)
            if any(wds):
                torch._foreach_add_(g, torch._foreach_mul(w, wds))
            torch._foreach_mul_(g, lrs)  # lr * (g + wd * w)
            if self.momentum != 0.0:
                mom = [s._data for s in states]
                torch._foreach_mul_(mom, self.momentum)
                torch._foreach_sub_(mom, g)
                torch._foreach_add_(w, mom)
            else:
                torch._foreach_sub_(w, g)
        return True


class Updater(object):
    """Holds each parameter's optimizer state and applies updates."""

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states: Dict[Any, Any] = {}

    def _state(self, index, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state(index, weight)
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


def get_updater(optimizer: Optimizer) -> Updater:
    return Updater(optimizer)
