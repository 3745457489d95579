"""BucketingModule of the PyTorch port: one executor per bucket, one
set of parameters.

Counterpart of ``mxtpu/module/bucketing_module.py``.  ``sym_gen(key)``
gives (symbol, data names, label names) for a bucket key (a sequence
length).  ``bind`` binds the default bucket's Module; a batch of
another bucket (``DataBatch.bucket_key``) binds that bucket's Module
on first use with ``shared_module`` set to the default one, so every
bucket's executor holds the same parameter, gradient and aux tensors,
and ``borrow_optimizer`` gives it the same optimizer, updater and
states.  ``forward``/``backward``/``update`` run the current bucket;
``fit`` is ``BaseModule.fit``.  A monitor is installed on every bucket's
executor, those bound later too.  ``save_checkpoint`` writes the
default bucket's symbol and the shared parameters, and ignores
``save_optimizer_states``, as the JAX package does.
"""
from __future__ import annotations

import logging
from typing import Any, Dict, Optional

from ..base import MXNetError
from ..context import current_context
from ..initializer import Uniform
from ..model import save_checkpoint
from .base_module import BaseModule
from .module import Module

__all__ = ["BucketingModule"]


class BucketingModule(BaseModule):
    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None):
        super().__init__(logger=logger)
        if default_bucket_key is None:
            raise MXNetError("default_bucket_key required")
        self._default_bucket_key = default_bucket_key
        self._sym_gen = sym_gen
        self._context = context if context is not None else current_context()
        self._fixed_param_names = fixed_param_names
        self._state_names = state_names
        self._group2ctxs = group2ctxs
        self._buckets: Dict[Any, Module] = {}
        self._curr_module: Optional[Module] = None
        self._curr_bucket_key = None
        self._params_dirty = False
        self._monitor = None

    def _reset_bind(self):
        self.binded = False
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None

    def _gen_module(self, bucket_key):
        symbol, data_names, label_names = self._sym_gen(bucket_key)
        return Module(symbol, data_names, label_names, logger=self.logger,
                      context=self._context,
                      fixed_param_names=self._fixed_param_names,
                      state_names=self._state_names,
                      group2ctxs=self._group2ctxs)

    @property
    def default_module(self) -> Module:
        return self._buckets[self._default_bucket_key]

    @property
    def data_names(self):
        if self.binded:
            return self._curr_module.data_names
        return self._sym_gen(self._default_bucket_key)[1]

    @property
    def output_names(self):
        if self.binded:
            return self._curr_module.output_names
        return self._sym_gen(self._default_bucket_key)[0].list_outputs()

    @property
    def data_shapes(self):
        return self._curr_module.data_shapes

    @property
    def label_shapes(self):
        return self._curr_module.label_shapes

    @property
    def output_shapes(self):
        return self._curr_module.output_shapes

    @property
    def symbol(self):
        return self._curr_module.symbol

    def get_params(self):
        if not (self.binded and self.params_initialized):
            raise MXNetError("bind() and init_params() first")
        self._curr_module._params_dirty = self._params_dirty
        params = self._curr_module.get_params()
        self._params_dirty = False
        return params

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        if self.params_initialized and not force_init:
            return
        if not self.binded:
            raise MXNetError("bind() first")
        self._curr_module.init_params(
            initializer=initializer, arg_params=arg_params,
            aux_params=aux_params, allow_missing=allow_missing,
            force_init=force_init, allow_extra=allow_extra)
        self.params_initialized = True
        self._params_dirty = False

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if force_rebind:
            self._reset_bind()
        if self.binded:
            self.logger.warning("Already bound, ignoring bind()")
            return
        if shared_module is not None:
            raise MXNetError("a BucketingModule takes no shared_module")
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True
        self._params_dirty = False
        module = self._gen_module(self._default_bucket_key)
        module.bind(data_shapes, label_shapes, for_training,
                    inputs_need_grad, grad_req=grad_req)
        self._curr_module = module
        self._curr_bucket_key = self._default_bucket_key
        self._buckets[self._default_bucket_key] = module

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """Make ``bucket_key``'s Module current, binding it first (to
        the default bucket's arrays and optimizer) if it is new."""
        if not self.binded:
            raise MXNetError("bind() first")
        if bucket_key not in self._buckets:
            module = self._gen_module(bucket_key)
            module.bind(data_shapes, label_shapes, self.for_training,
                        self.inputs_need_grad,
                        shared_module=self.default_module)
            if self._monitor is not None:
                module.install_monitor(self._monitor)
            if self.optimizer_initialized:
                module.borrow_optimizer(self.default_module)
            self._buckets[bucket_key] = module
        self._curr_module = self._buckets[bucket_key]
        self._curr_bucket_key = bucket_key

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        if not (self.binded and self.params_initialized):
            raise MXNetError("bind() and init_params() first")
        if self.optimizer_initialized and not force_init:
            return
        self.default_module.init_optimizer(kvstore, optimizer,
                                           optimizer_params,
                                           force_init=force_init)
        for mod in self._buckets.values():
            if mod is not self.default_module:
                mod.borrow_optimizer(self.default_module)
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        if not (self.binded and self.params_initialized):
            raise MXNetError("bind() and init_params() first")
        bucket_key = getattr(data_batch, "bucket_key", None)
        if bucket_key is None:
            bucket_key = self._default_bucket_key
        self.switch_bucket(bucket_key, data_batch.provide_data,
                           data_batch.provide_label)
        self._curr_module.forward(data_batch, is_train=is_train)

    def backward(self, out_grads=None):
        self._curr_module.backward(out_grads=out_grads)

    def update(self):
        self._params_dirty = True
        self._curr_module.update()

    def get_outputs(self, merge_multi_context=True):
        return self._curr_module.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        return self._curr_module.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        self._curr_module.update_metric(eval_metric, labels, pre_sliced)

    def install_monitor(self, mon):
        if not self.binded:
            raise MXNetError("bind() first")
        self._monitor = mon
        for mod in self._buckets.values():
            mod.install_monitor(mon)

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        """The default bucket's symbol and the shared parameters
        (``save_optimizer_states`` is ignored, as in the JAX
        package)."""
        arg_p, aux_p = self.get_params()
        save_checkpoint(prefix, epoch, self.default_module.symbol, arg_p,
                        aux_p)
