"""Optimizers of the PyTorch port.

Counterpart of ``mxtpu/optimizer/optimizer.py``: the ``Optimizer`` base
(``lr``/``wd`` and their per-parameter multipliers, an
``lr_scheduler``, ``rescale_grad``, ``clip_gradient``, the update
counts, multi-precision), the sixteen registered optimizers (``sgd``,
``signum``, ``signsgd``, ``ftml``, ``nag``, ``sgld``, ``dcasgd``,
``adam``, ``adagrad``, ``rmsprop``, ``adadelta``, ``ftrl``, ``adamax``,
``nadam``, ``lbsgd``, ``test``), the ``Updater`` and ``get_updater``,
``create`` and ``register``, ``param_dict`` (gluon's Parameters, whose
``lr_mult``/``wd_mult`` win) and the Updater's ``get_states``/
``set_states`` (the update counts and Nadam's ``m_schedule`` with
``dump_optimizer``).  Each optimizer's per-parameter ``update`` runs
its update op (``mxtpu_torch/ops/optimizer_ops.py``) or, where the JAX
package computes outside an op (SGLD, DCASGD, Adamax, Nadam, LBSGD's
norms), the same arithmetic on the tensors; SGD's and Adam's
``fused_update_multi`` do it over every parameter at once with
``torch._foreach_*`` (the JAX package's one jitted call).

``multi_precision=True`` keeps a float32 master copy of each bfloat16
or float16 weight: the update runs on the master (the gradient cast to
float32) and the weight is the master cast back.  SGD updates a tree
of low-precision weights in one ``torch._foreach_*`` sequence on the
masters (the JAX package's ``sgd_mp``) and declines a tree that mixes
precisions, which is then updated one parameter at a time.

A row-sparse gradient (``RowSparseNDArray``, rows sorted and unique)
takes the lazy update: SGD (``lazy_update=True``, with or without
momentum) and AdaGrad read, update and write back only the gradient's
rows of the weight and its states (``index_select``, ``index_copy_``);
every other row stays as it was, bit for bit, weight decay included,
as the reference's ``sgd_update``/``_sparse_adagrad_update`` with a
row_sparse gradient.  ``fused_update_multi`` declines any tree with a
sparse gradient, and the Updater then updates one parameter at a time.
The other optimizers take a sparse gradient densified.

``make_scan_step`` gives the whole-tree step that
``mxtpu_torch.fused_train.FusedTrainLoop`` runs K times a call (SGD
and Adam on full-precision trees): a :class:`ScanStep` whose ``step``
updates the weights and states in place and reads each step's learning
rates from a device tensor row (so that a captured CUDA graph reads new
rates on every replay), and whose ``host_sched`` computes those rows up
front on the host, scheduler and Adam's bias correction included,
without touching a counter.

The class flags ``zero1_compatible`` and ``single_apply_update`` are
the JAX package's (its sharded optimizer-state engine reads them).
"""
from __future__ import annotations

import math
import pickle
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..base import MXNetError
from ..ndarray.ndarray import array, imperative_invoke, zeros

__all__ = ["Optimizer", "SGD", "Signum", "SignSGD", "FTML", "DCASGD", "NAG",
           "SGLD", "Adam", "AdaGrad", "RMSProp", "AdaDelta", "Ftrl",
           "Adamax", "Nadam", "LBSGD", "Test", "ScanStep", "Updater",
           "get_updater", "create", "register"]

_LOWP = (torch.float16, torch.bfloat16)


class _Mults(object):
    """What the optimizer reads of a gluon Parameter."""

    __slots__ = ("lr_mult", "wd_mult")

    def __init__(self, lr_mult, wd_mult):
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult

    def __getstate__(self):
        return (self.lr_mult, self.wd_mult)

    def __setstate__(self, state):
        self.lr_mult, self.wd_mult = state


def _is_lowp(weight) -> bool:
    return weight._data.dtype in _LOWP


class Optimizer(object):
    opt_registry: Dict[str, type] = {}

    # True where ``update`` is elementwise in (weight, grad, state) with
    # host scalars from the update counts alone, so that an update cut
    # into slices equals the whole one; False for whole-weight norms
    # (LBSGD), per-call noise (SGLD) and per-call schedules (Nadam)
    zero1_compatible = True
    # True where a dense ``update`` is exactly one update op
    single_apply_update = False

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

    def __getstate__(self):
        """Pickled (``set_optimizer`` sends the optimizer to the
        parameter servers), each gluon Parameter of ``param_dict``
        travels as its ``lr_mult`` and ``wd_mult`` alone, not with its
        arrays."""
        state = dict(self.__dict__)
        state["param_dict"] = {i: _Mults(p.lr_mult, p.wd_mult)
                               for i, p in self.param_dict.items()}
        return state

    def create_state(self, index, weight):
        return None

    def create_state_multi_precision(self, index, weight):
        """``create_state``; under ``multi_precision`` a bfloat16 or
        float16 weight gets (its float32 master copy, the master's
        state)."""
        if self.multi_precision and _is_lowp(weight):
            master = weight.astype(np.float32)
            return (master, self.create_state(index, master))
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def update_multi_precision(self, index, weight, grad, state):
        """``update``; under ``multi_precision`` a low-precision weight's
        float32 master takes the update from the gradient cast to
        float32, and the weight becomes the master cast back."""
        if self.multi_precision and _is_lowp(weight):
            master, base_state = state
            self.update(index, master, grad.astype(np.float32), base_state)
            weight._set_data(master._data.to(weight._data.dtype))
        else:
            self.update(index, weight, grad, state)

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


def _any_sparse(grads) -> bool:
    return any(g.stype != "default" for g in grads)


def _lazy_rows(opt, grad):
    """(rows, g): a row-sparse gradient's row ids and its rows rescaled
    and clipped, as the dense ops do."""
    g = grad._data * opt.rescale_grad
    if opt.clip_gradient is not None and opt.clip_gradient >= 0:
        g = torch.clamp(g, -opt.clip_gradient, opt.clip_gradient)
    return grad._aux[0], g


def _write_rows(t, rows, value):
    with torch.no_grad():
        t._data.index_copy_(0, rows, value)


def _lazy_sgd(opt, weight, grad, mom, lr, wd):
    """SGD on the gradient's rows only (the JAX package's
    ``_lazy_sgd_kernel``)."""
    rows, g = _lazy_rows(opt, grad)
    wr = weight._data.detach().index_select(0, rows)
    if mom is None:
        _write_rows(weight, rows, wr - lr * (g + wd * wr))
        return
    mr = mom._data.index_select(0, rows)
    mr = opt.momentum * mr - lr * (g + wd * wr)
    _write_rows(weight, rows, wr + mr)
    _write_rows(mom, rows, mr)


def _lazy_adagrad(opt, weight, grad, history, lr, wd):
    """AdaGrad on the gradient's rows only (the JAX package's
    ``_lazy_adagrad_kernel``)."""
    rows, g = _lazy_rows(opt, grad)
    hr = history._data.index_select(0, rows) + g * g
    wr = weight._data.detach().index_select(0, rows)
    _write_rows(weight, rows, wr - lr * (g / (torch.sqrt(hr)
                                              + opt.float_stable_eps)
                                         + wd * wr))
    _write_rows(history, rows, hr)


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

    single_apply_update = True

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
        if grad.stype == "row_sparse" and self.lazy_update:
            _lazy_sgd(self, weight, grad, state, lr, wd)
            return
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
        parameter in one sequence of ``torch._foreach_*`` calls; under
        ``multi_precision`` a tree of low-precision weights is updated
        on its float32 masters, each weight then cast from its master
        (the JAX package's ``sgd_mp``), and a tree that mixes
        precisions is declined."""
        if _any_sparse(grads):
            return False
        mp = self.multi_precision and any(_is_lowp(w) for w in weights)
        if mp and not all(_is_lowp(w) for w in weights):
            return False
        for i in indices:
            self._update_count(i)
        lrs = [self._get_lr(i) for i in indices]
        wds = [self._get_wd(i) for i in indices]
        has_mom = self.momentum != 0.0
        g = [x._data for x in grads]
        if mp:
            masters = [s[0]._data for s in states]
            mom = [s[1]._data for s in states] if has_mom else []
            g = [t.float() for t in g]
        else:
            masters = [x._data for x in weights]
            mom = [s._data for s in states] if has_mom else []
        self._foreach_step(masters, mom, g, wds,
                           lambda u: torch._foreach_mul_(u, lrs))
        if mp:
            with torch.no_grad():
                torch._foreach_copy_([w._data for w in weights], masters)
        return True

    def make_scan_step(self, indices, weights):
        # a tree of low-precision weights under multi_precision keeps the
        # per-call path (its masters are not the loop's weights)
        if self.multi_precision and any(_is_lowp(w) for w in weights):
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


def _zeros_like(weight):
    return zeros(weight.shape, ctx=weight.ctx, dtype=weight.dtype)


def _dense(grad):
    return grad.todense() if grad.stype != "default" else grad


def _clipped(opt, grad):
    """``clip(rescale * grad)`` as a new tensor."""
    g = _dense(grad)._data * opt.rescale_grad
    if opt.clip_gradient is not None:
        g = torch.clamp(g, -opt.clip_gradient, opt.clip_gradient)
    return g


@register
class Signum(Optimizer):
    """Signum: ``mom = momentum * mom - (1 - momentum) * (g + wd * w)``,
    ``w = (1 - lr * wd_lh) * w + lr * sign(mom)`` (``signum_update``);
    without momentum SignSGD's ``w -= lr * (sign(g) + wd * w)``."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        kw = self._common_kwargs()
        if state is None:
            self._apply("signsgd_update", weight, grad, (), lr=lr, wd=wd,
                        **kw)
        else:
            self._apply("signum_update", weight, grad, (state,), lr=lr,
                        wd=wd, momentum=self.momentum, wd_lh=self.wd_lh,
                        **kw)


@register
class SignSGD(Signum):
    """Signum without momentum (``signsgd_update``)."""

    def __init__(self, **kwargs):
        kwargs.setdefault("momentum", 0.0)
        super().__init__(**kwargs)


@register
class FTML(Optimizer):
    """FTML (``ftml_update``, its ``t`` the parameter's update count)."""

    def __init__(self, beta1=0.6, beta2=0.999, epsilon=1e-8, **kwargs):
        super().__init__(**kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight),
                _zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        self._apply("ftml_update", weight, grad, state, lr=lr, wd=wd,
                    beta1=self.beta1, beta2=self.beta2, epsilon=self.epsilon,
                    t=self._index_update_count[index],
                    **self._common_kwargs())


@register
class NAG(Optimizer):
    """Nesterov momentum as the JAX package has it (``nag_mom_update``,
    not ``torch.optim.SGD(nesterov=True)``): ``g = clip(rescale * grad)
    + wd * w``, ``mom = momentum * mom + g``, ``w -= lr * (g + momentum
    * mom)``; plain SGD without momentum."""

    single_apply_update = True

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        kw = self._common_kwargs()
        if state is None:
            self._apply("sgd_update", weight, grad, (), lr=lr, wd=wd, **kw)
        else:
            self._apply("nag_mom_update", weight, grad, (state,), lr=lr,
                        wd=wd, momentum=self.momentum, **kw)


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics: ``w -= lr / 2 * (g + wd *
    w)`` plus normal noise of variance ``lr``, drawn on the weight's
    device from ``mxtpu_torch.random`` on each call."""

    zero1_compatible = False

    def update(self, index, weight, grad, state):
        from .. import random as _rnd

        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        g = _clipped(self, grad)
        noise = _rnd.normal(0, math.sqrt(lr), shape=weight.shape,
                            ctx=weight.ctx)._data
        w = weight._data
        weight._set_data(w - (lr / 2) * (g + wd * w) + noise)


@register
class DCASGD(Optimizer):
    """Delay-compensated SGD: the step adds ``lamda * g * g * (w -
    previous)`` to the gradient; the state is (momentum or None, the
    previous weight)."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.weight_previous: Dict[Any, Any] = {}
        self.lamda = lamda

    def create_state(self, index, weight):
        mom = None if self.momentum == 0.0 else _zeros_like(weight)
        return (mom, weight.copy())

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        g = _clipped(self, grad)
        mom, previous = state
        w = weight._data.clone()
        dc = self.lamda * g * g * (w - previous._data)
        if mom is not None:
            mom._set_data(self.momentum * mom._data - lr * (g + wd * w + dc))
            step = mom._data
        else:
            step = -lr * (g + wd * w + dc)
        previous._set_data(w)
        weight._set_data(w + step)


@register
class Adam(Optimizer):
    """Adam with the bias correction folded into the rate: at the
    parameter's t-th update ``lr_t = lr * sqrt(1 - beta2^t) / (1 -
    beta1^t)``, ``g = clip(rescale * grad) + wd * w``, ``m = beta1 * m +
    (1 - beta1) * g``, ``v = beta2 * v + (1 - beta2) * g^2``, ``w -= lr_t
    * m / (sqrt(v) + epsilon)`` (the ``adam_update`` op)."""

    single_apply_update = True

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
        if self.multi_precision or _any_sparse(grads):
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


@register
class AdaGrad(Optimizer):
    """AdaGrad: ``g = clip(rescale * grad)``, ``h += g^2``, ``w -= lr *
    (g / (sqrt(h) + eps) + wd * w)`` (the ``_sparse_adagrad_update``
    op; lazily on a row-sparse gradient's rows)."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return zeros(weight.shape, ctx=weight.ctx, dtype=weight.dtype)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        if grad.stype == "row_sparse":
            _lazy_adagrad(self, weight, grad, state, lr, wd)
            return
        self._apply("_sparse_adagrad_update", weight, grad, (state,), lr=lr,
                    wd=wd, epsilon=self.float_stable_eps,
                    **self._common_kwargs())


@register
class RMSProp(Optimizer):
    """RMSProp as the JAX package has it (``epsilon`` inside the square
    root, not torch's): ``rmsprop_update``; ``centered`` takes
    ``rmspropalex_update``, whose state is (n, g, delta)."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1, self.gamma2 = gamma1, gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return (_zeros_like(weight), _zeros_like(weight),
                    _zeros_like(weight))
        return _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        kw = self._common_kwargs()
        if self.clip_weights:
            kw["clip_weights"] = self.clip_weights
        if self.centered:
            self._apply("rmspropalex_update", weight, grad, state, lr=lr,
                        wd=wd, gamma1=self.gamma1, gamma2=self.gamma2,
                        epsilon=self.epsilon, **kw)
        else:
            self._apply("rmsprop_update", weight, grad, (state,), lr=lr,
                        wd=wd, gamma1=self.gamma1, epsilon=self.epsilon,
                        **kw)


@register
class AdaDelta(Optimizer):
    """AdaDelta (``adadelta_update``; no learning rate)."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho, self.epsilon = rho, epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        self._apply("adadelta_update", weight, grad, state, rho=self.rho,
                    epsilon=self.epsilon, wd=self._get_wd(index),
                    **self._common_kwargs())


@register
class Ftrl(Optimizer):
    """FTRL-proximal (``ftrl_update``; state (z, n))."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1, self.beta = lamda1, beta

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        self._apply("ftrl_update", weight, grad, state, lr=lr, wd=wd,
                    lamda1=self.lamda1, beta=self.beta,
                    **self._common_kwargs())


@register
class Adamax(Optimizer):
    """Adamax: ``g = rescale * grad + wd * w``, clipped after the decay
    (as the JAX package clips it), ``m = beta1 * m + (1 - beta1) * g``,
    ``u = max(beta2 * u, |g|)``, ``w -= lr / (1 - beta1^t) * m / (u +
    1e-8)``."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2 = beta1, beta2

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        lr /= (1.0 - self.beta1 ** self._index_update_count[index])
        w = weight._data
        g = _dense(grad)._data * self.rescale_grad + wd * w
        if self.clip_gradient is not None:
            g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
        m, u = state
        m._set_data(self.beta1 * m._data + (1.0 - self.beta1) * g)
        u._set_data(torch.maximum(self.beta2 * u._data, torch.abs(g)))
        weight._set_data(w - lr * m._data / (u._data + 1e-8))


@register
class Nadam(Optimizer):
    """Nadam; ``m_schedule`` advances once per ``update`` call (so a
    whole-tree step advances it once per parameter, as in the JAX
    package), and ``Updater.get_states(dump_optimizer=True)`` saves
    it."""

    zero1_compatible = False

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2 = beta1, beta2
        self.epsilon = epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        w = weight._data
        g = _dense(grad)._data * self.rescale_grad + wd * w
        if self.clip_gradient is not None:
            g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
        momentum_t = self.beta1 * (1.0 - 0.5 * 0.96 ** (
            t * self.schedule_decay))
        momentum_t_1 = self.beta1 * (1.0 - 0.5 * 0.96 ** (
            (t + 1) * self.schedule_decay))
        self.m_schedule *= momentum_t
        m_schedule_next = self.m_schedule * momentum_t_1
        m, v = state
        m._set_data(self.beta1 * m._data + (1.0 - self.beta1) * g)
        v._set_data(self.beta2 * v._data + (1.0 - self.beta2) * g * g)
        g_prime = g / (1.0 - self.m_schedule)
        m_prime = m._data / (1.0 - m_schedule_next)
        v_prime = v._data / (1.0 - self.beta2 ** t)
        m_bar = (1.0 - momentum_t) * g_prime + momentum_t_1 * m_prime
        weight._set_data(w - lr * m_bar / (v_prime ** 0.5 + self.epsilon))


@register
class LBSGD(SGD):
    """Large-batch SGD: each parameter's rate scaled by ``|w| / (|g| +
    wd |w| + 1e-9)`` (1 where either norm is 0), the norms of the whole
    weight and gradient read on the host, one sync a parameter; no
    whole-tree path and no fused-loop step.  The norms are summed in
    float64: in float32 a 2.4M-element norm is off by about 4e-5, by
    an amount that depends on the device's order of summation."""

    zero1_compatible = False
    single_apply_update = False

    def __init__(self, momentum=0.0, multi_precision=False,
                 warmup_strategy="linear", warmup_epochs=5, batch_scale=1,
                 updates_per_epoch=32, begin_epoch=0, num_epochs=60,
                 **kwargs):
        super().__init__(momentum=momentum, multi_precision=multi_precision,
                         **kwargs)
        self.warmup_strategy = warmup_strategy
        self.warmup_epochs = warmup_epochs
        self.batch_scale = batch_scale
        self.updates_per_epoch = updates_per_epoch
        self.num_epochs = num_epochs

    def fused_update_multi(self, indices, weights, grads, states) -> bool:
        return False

    def make_scan_step(self, indices, weights):
        return None

    def _get_lars(self, weight, grad, wd):
        w_norm, g_norm = torch.stack([
            torch.linalg.vector_norm(weight._data, dtype=torch.float64),
            torch.linalg.vector_norm(_dense(grad)._data,
                                     dtype=torch.float64)]).tolist()
        if w_norm > 0 and g_norm > 0:
            return w_norm / (g_norm + wd * w_norm + 1e-9)
        return 1.0

    def update(self, index, weight, grad, state):
        self._update_count(index)
        wd = self._get_wd(index)
        lr = self._get_lr(index) * self._get_lars(weight, grad, wd)
        kw = self._common_kwargs()
        if state is None:
            self._apply("sgd_update", weight, grad, (), lr=lr, wd=wd, **kw)
        else:
            self._apply("sgd_mom_update", weight, grad, (state,), lr=lr,
                        wd=wd, momentum=self.momentum, **kw)


@register
class Test(Optimizer):
    """``w += rescale * grad``; the state holds the new weight."""

    def create_state(self, index, weight):
        return _zeros_like(weight)

    def update(self, index, weight, grad, state):
        weight._set_data(weight._data + _dense(grad)._data * self.rescale_grad)
        state._set_data(weight._data)


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
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self._state(index, weight))

    def update_multi(self, triples):
        """Update many parameters, ``triples`` of (index, grad, weight):
        at once where the optimizer can, else one by one."""
        states = [self._state(i, w) for i, _, w in triples]
        if len(triples) > 1 and self.optimizer.fused_update_multi(
                [t[0] for t in triples], [t[2] for t in triples],
                [t[1] for t in triples], states):
            return
        for (idx, g, w), st in zip(triples, states):
            self.optimizer.update_multi_precision(idx, w, g, st)

    def get_states(self, dump_optimizer=False) -> bytes:
        """The states (as host arrays) and, with ``dump_optimizer``, the
        update counters and Nadam's ``m_schedule``, pickled (the
        reference's ``get_states``)."""
        opt_state = None
        if dump_optimizer:
            opt_state = {
                "num_update": self.optimizer.num_update,
                "begin_num_update": self.optimizer.begin_num_update,
                "_index_update_count": dict(
                    self.optimizer._index_update_count)}
            if hasattr(self.optimizer, "m_schedule"):
                opt_state["m_schedule"] = self.optimizer.m_schedule
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
