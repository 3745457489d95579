"""Trainer of the PyTorch port (counterpart of
``mxtpu/gluon/trainer.py``), on one device.

``step(batch_size)`` sets the optimizer's ``rescale_grad`` to
``scale / batch_size``, reduces the gradients through the kvstore when
there is one, and updates every Parameter with a gradient in one
``Updater.update_multi`` call (the optimizer's ``torch._foreach_*``
step over all of them; with a row-sparse gradient among them, the
optimizer updates one Parameter at a time, the row-sparse ones
lazily).  The optimizer sees each Parameter through
``param_dict``, so its ``lr_mult`` and ``wd_mult`` apply; a weight
decay applies to every such Parameter, biases included, as gluon's
does.

The kvstore rule is the reference's: with one device, ``"local"`` and
``"device"`` (the default) mean no kvstore and a local update.  A store
object, or another name (``"dist_sync"``, ``"dist_async"``...), is
used: each gradient is pushed to it (2-bit compressed with
``compression_params``); with ``update_on_kvstore`` the store runs the
optimizer and the weights are pulled back, else the summed gradients
are pulled and updated here.  Several devices and ZeRO-1 are not
ported (ROADMAP A15b); the bad-step guard and the health, perf,
tracing and checkpoint hooks are not ported either (ROADMAP A10b,
A17, A18).
"""
from __future__ import annotations

from typing import List

from ..base import MXNetError
from .. import optimizer as opt_mod
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]


class Trainer(object):
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise MXNetError("params must be a ParameterDict/list")
        self._params: List[Parameter] = []
        for p in params:
            if not isinstance(p, Parameter):
                raise MXNetError("invalid parameter %r" % p)
            self._params.append(p)
        self._compression_params = compression_params
        optimizer_params = optimizer_params or {}
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        self._init_optimizer(optimizer, optimizer_params)
        self._kvstore_type = kvstore
        self._kvstore = None
        self._update_on_kvstore = update_on_kvstore
        self._kv_initialized = False
        self._num_steps = 0

    def _init_optimizer(self, optimizer, optimizer_params):
        param_dict = dict(enumerate(self._params))
        if isinstance(optimizer, opt_mod.Optimizer):
            if optimizer_params and list(optimizer_params) != \
                    ["rescale_grad"]:
                raise MXNetError("optimizer_params must be None when "
                                 "optimizer is an Optimizer instance")
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt_mod.create(optimizer,
                                             param_dict=param_dict,
                                             **optimizer_params)
        self._updater = opt_mod.get_updater(self._optimizer)

    def _init_kvstore(self):
        contexts = None
        for param in self._params:
            ctx = param.list_ctx()
            if contexts is not None and contexts != ctx:
                raise MXNetError("all Parameters must be on the same "
                                 "devices, got %s and %s" % (contexts, ctx))
            contexts = ctx
        if len(contexts or ()) > 1:
            raise MXNetError("a Trainer over %d devices is not ported "
                             "(ROADMAP A15b)" % len(contexts))
        kv = self._kvstore_type
        if kv is None or (isinstance(kv, str)
                          and kv in ("", "none", "local", "device")):
            self._kvstore = None
            self._update_on_kvstore = False
        else:
            from .. import kvstore as kv_mod

            self._kvstore = kv if not isinstance(kv, str) \
                else kv_mod.create(kv)
            if self._compression_params:
                self._kvstore.set_gradient_compression(
                    self._compression_params)
            if self._update_on_kvstore is None:
                self._update_on_kvstore = False
            if self._update_on_kvstore:
                self._kvstore.set_optimizer(self._optimizer)
            for i, param in enumerate(self._params):
                if param.grad_req != "null":
                    self._kvstore.init(i, param.data())
        self._kv_initialized = True

    @property
    def learning_rate(self):
        opt = self._optimizer
        return opt.lr if opt.lr_scheduler is None \
            else opt.lr_scheduler(opt.num_update)

    @property
    def optimizer(self):
        return self._optimizer

    @property
    def step_count(self):
        return self._num_steps

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def step(self, batch_size, ignore_stale_grad=False):
        """Reduce the gradients and update the Parameters, with the
        gradients scaled by ``1 / batch_size``."""
        if not self._kv_initialized:
            self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        self._allreduce_grads()
        self._update(ignore_stale_grad)
        self._num_steps += 1

    def allreduce_grads(self):
        if not self._kv_initialized:
            self._init_kvstore()
        self._allreduce_grads()

    def _allreduce_grads(self):
        """Push each gradient to the store; without
        ``update_on_kvstore``, pull the sum back into the gradient."""
        if self._kvstore is None:
            return
        for i, param in enumerate(self._params):
            if param.grad_req != "null":
                self._kvstore.push(i, param.list_grad(), priority=-i)
                if not self._update_on_kvstore:
                    self._kvstore.pull(i, param.list_grad(), priority=-i,
                                       ignore_sparse=False)

    def update(self, batch_size, ignore_stale_grad=False):
        """The update of ``step`` alone (after ``allreduce_grads``)."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore:
            raise MXNetError("update() not supported with "
                             "update_on_kvstore=True; call step()")
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False):
        triples = []
        for i, param in enumerate(self._params):
            if param.grad_req == "null":
                continue
            if param._data is None:
                if not ignore_stale_grad:
                    raise MXNetError("Parameter %s has not been "
                                     "initialized" % param.name)
                continue
            if self._update_on_kvstore:
                self._kvstore.pull(i, param.list_data(), priority=-i)
                continue
            triples.append((i, param.list_grad()[0], param.list_data()[0]))
        if triples:
            self._updater.update_multi(triples)

    def save_states(self, fname):
        """The optimizer's states and update counters, to ``fname``."""
        if not self._kv_initialized:
            self._init_kvstore()
        with open(fname, "wb") as f:
            f.write(self._updater.get_states(dump_optimizer=True))

    def load_states(self, fname):
        """Restore what ``save_states`` wrote, onto the Parameters'
        device."""
        if not self._kv_initialized:
            self._init_kvstore()
        with open(fname, "rb") as f:
            states = f.read()
        ctx = self._params[0].list_ctx()[0] if self._params else None
        self._updater.set_states(states, ctx=ctx)
        self._updater.optimizer = self._optimizer
