"""Module of the PyTorch port: symbolic training on one device.

Counterpart of ``mxtpu/module/module.py``: ``bind`` builds the executor
group, ``init_params`` fills the parameters (from given arrays or an
initializer, by name), ``init_optimizer`` makes the optimizer with
``rescale_grad = 1/batch`` and its updater (no kvstore on one device),
``forward``/``backward``/``update`` run a step, ``get_params``/
``set_params``, ``get_outputs``, ``save_checkpoint`` and ``load`` (with
the optimizer's states, ``prefix-%04d.states``, as the JAX package
writes them), ``save_optimizer_states``/``load_optimizer_states``,
``output_shapes``, ``get_input_grads``, ``install_monitor`` and
``warmup``;
``bind(shared_module=...)`` and ``borrow_optimizer`` let
``BucketingModule``'s buckets share one set of parameters and one
optimizer.  ``context=None`` is the card.  ``init_optimizer(kvstore=)``
takes a store object or name (``model._create_kvstore``); over a
``dist_*`` store the optimizer runs on the servers, ``update`` pushes
the gradients and pulls the weights back, and a ``_sync`` store scales
``rescale_grad`` by the number of workers.  An inference batch of
another size goes through the executor's bucketed forward when a bucket
policy is on (``MXTPU_SHAPE_BUCKETS``), with no rebind; otherwise, and
in training, the module rebinds at the batch's shapes.  ``group2ctxs``
(and ``bind``'s ``group2ctx``) may only name the module's one device.
Several devices, ``load_latest`` (the JAX package's checkpoints carry a
CRC manifest that the port does not write: A17) and the
tune/sharding/health/telemetry hooks are not ported.
"""
from __future__ import annotations

import logging
import os
from typing import Dict, Optional

import numpy as np
import torch

from ..base import MXNetError
from ..context import current_context, resolve
from ..initializer import InitDesc, Uniform
from ..io.io import DataDesc
from ..model import (_create_kvstore, _initialize_kvstore, _update_params,
                     _update_params_on_kvstore, load_checkpoint,
                     save_checkpoint)
from ..ndarray.ndarray import NDArray
from .. import optimizer as opt_mod
from ..symbol.symbol import check_group2ctx
from .base_module import BaseModule
from .executor_group import DataParallelExecutorGroup

__all__ = ["Module"]


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None):
        super().__init__(logger=logger)
        if context is None:
            context = [current_context()]
        if not isinstance(context, (list, tuple)):
            context = [context]
        self._context = [resolve(c) for c in context]
        for g2c in (group2ctxs if isinstance(group2ctxs, (list, tuple))
                    else [group2ctxs]):
            check_group2ctx(g2c, self._context[0])
        self._symbol = symbol
        self._data_names = list(data_names or [])
        self._label_names = list(label_names or [])
        arg_names = symbol.list_arguments()
        input_names = self._data_names + self._label_names + \
            list(state_names or [])
        # a name that several variable nodes share is one parameter
        # (the executor binds it once), updated once a step
        self._param_names = list(dict.fromkeys(
            n for n in arg_names if n not in input_names))
        self._fixed_param_names = list(fixed_param_names or [])
        self._aux_names = symbol.list_auxiliary_states()
        self._output_names = symbol.list_outputs()
        self._arg_params: Optional[Dict[str, NDArray]] = None
        self._aux_params: Optional[Dict[str, NDArray]] = None
        self._params_dirty = False
        self._exec_group: Optional[DataParallelExecutorGroup] = None
        self._optimizer = None
        self._kvstore = None
        self._update_on_kvstore = False
        self._updater = None
        self._monitor = None

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module from a checkpoint, its arrays on the module's
        device; with ``load_optimizer_states`` its optimizer states
        (``prefix-%04d.states``) are restored by ``init_optimizer``."""
        ctx = kwargs.get("context")
        ctx = ctx[0] if isinstance(ctx, (list, tuple)) else ctx
        sym, args, auxs = load_checkpoint(prefix, epoch, ctx=ctx)
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params = args
        mod._aux_params = auxs
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = "%s-%04d.states" % (prefix, epoch)
        return mod

    @staticmethod
    def load_latest(prefix, load_optimizer_states=False, **kwargs):
        raise MXNetError("load_latest needs the CRC manifest of the JAX "
                         "package's atomic checkpoints, which the port does "
                         "not write (ROADMAP A17)")

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        """``prefix-symbol.json``, ``prefix-%04d.params`` and, with
        ``save_optimizer_states``, ``prefix-%04d.states``."""
        self._sync_params_from_devices()
        states = self._optimizer_state_bytes() if save_optimizer_states \
            else None
        save_checkpoint(prefix, epoch, self.symbol, self._arg_params,
                        self._aux_params, states=states)

    def _optimizer_state_bytes(self):
        if not self.optimizer_initialized:
            raise MXNetError("init_optimizer() first")
        if self._update_on_kvstore:
            self._kvstore._need_updater()
            return self._kvstore._updater.get_states(dump_optimizer=False)
        return self._updater.get_states()

    def save_optimizer_states(self, fname):
        """The updater's states (the store's, when it updates) to
        ``fname``."""
        with open(fname, "wb") as f:
            f.write(self._optimizer_state_bytes())

    def load_optimizer_states(self, fname):
        """Restore what ``save_optimizer_states`` wrote, onto the
        module's device."""
        if not self.optimizer_initialized:
            raise MXNetError("init_optimizer() first")
        if self._update_on_kvstore:
            self._kvstore.load_optimizer_states(fname)
        else:
            with open(fname, "rb") as f:
                self._updater.set_states(f.read(), ctx=self._context[0])

    # -- properties ---------------------------------------------------------
    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        if not self.binded:
            raise MXNetError("not bound")
        return self._exec_group.data_shapes

    @property
    def label_shapes(self):
        if not self.binded:
            raise MXNetError("not bound")
        return self._exec_group.label_shapes

    @property
    def output_shapes(self):
        if not self.binded:
            raise MXNetError("not bound")
        shapes = self.symbol.infer_shape(
            **{d.name: d.shape for d in
               self.data_shapes + (self.label_shapes or [])})[1]
        return list(zip(self._output_names, shapes))

    # -- params -------------------------------------------------------------
    def get_params(self):
        if not (self.binded and self.params_initialized):
            raise MXNetError("bind() and init_params() first")
        self._sync_params_from_devices()
        return (self._arg_params, self._aux_params)

    def _sync_params_from_devices(self):
        if self._params_dirty and self._exec_group is not None:
            self._exec_group.get_params(self._arg_params, self._aux_params)
            if self._kvstore is not None and self._update_on_kvstore:
                for name, arr in sorted(self._arg_params.items()):
                    self._kvstore.pull(name, arr)
            self._params_dirty = False

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        """Fill every parameter and aux state: from ``arg_params``/
        ``aux_params`` (NDArrays or numpy arrays) by name, else by the
        initializer."""
        if self.params_initialized and not force_init:
            return
        if not self.binded:
            raise MXNetError("bind() first")
        g = self._exec_group
        if self._arg_params is None:
            self._arg_params = {
                name: NDArray(torch.zeros_like(arrs[0]._data))
                for name, arrs in zip(g.param_names, g.param_arrays)}
        if self._aux_params is None:
            self._aux_params = {
                name: NDArray(torch.zeros_like(arrs[0]._data))
                for name, arrs in zip(g.aux_names, g.aux_arrays)}
        attr_dict = self.symbol.attr_dict()

        def _impl(name, arr, cache):
            if cache is not None and name in cache:
                src = cache[name]
                arr._set_data(src._data if isinstance(src, NDArray)
                              else torch.tensor(np.asarray(src)))
            elif cache is not None and not allow_missing:
                raise MXNetError("%s not found in provided params" % name)
            elif initializer is not None:
                initializer(InitDesc(name, attrs=attr_dict.get(name, {})),
                            arr)

        for name, arr in sorted(self._arg_params.items()):
            _impl(name, arr, arg_params)
        for name, arr in sorted(self._aux_params.items()):
            _impl(name, arr, aux_params)
        self.params_initialized = True
        self._params_dirty = False
        g.set_params(self._arg_params, self._aux_params,
                     allow_extra=allow_extra)

    # -- bind ---------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if force_rebind:
            self._exec_group = None
            self.binded = False
        if self.binded:
            self.logger.warning("Already bound, ignoring bind()")
            return
        shared_group = None
        if shared_module is not None:
            if not (shared_module.binded and
                    shared_module.params_initialized):
                raise MXNetError("shared_module must be bound and "
                                 "initialized")
            shared_group = shared_module._exec_group
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True
        self._exec_group = DataParallelExecutorGroup(
            self._symbol, self._context, None, data_shapes,
            label_shapes if for_training else (label_shapes or None),
            self._param_names, for_training, inputs_need_grad, shared_group,
            logger=self.logger, fixed_param_names=self._fixed_param_names,
            grad_req=grad_req)
        if shared_module is not None:
            # the shared arrays already hold the parameters
            self._arg_params = shared_module._arg_params
            self._aux_params = shared_module._aux_params
            self.params_initialized = True
        elif self.params_initialized:
            self._exec_group.set_params(self._arg_params, self._aux_params)

    # -- optimizer ----------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """Make the optimizer (by name, with ``rescale_grad`` = 1 / the
        batch over all workers of a ``dist_*_sync`` store, unless
        given) and either send it to the store or make its updater."""
        if not (self.binded and self.params_initialized):
            raise MXNetError("bind() and init_params() first")
        if self.optimizer_initialized and not force_init:
            return
        self._sync_params_from_devices()
        kvstore, update_on_kvstore = _create_kvstore(
            kvstore, len(self._context), self._arg_params)
        batch_size = self._exec_group.batch_size
        if kvstore and "dist" in kvstore.type and "_sync" in kvstore.type:
            batch_size *= kvstore.num_workers
        rescale_grad = 1.0 / batch_size
        idx2name = dict(enumerate(self._exec_group.param_names))
        if isinstance(optimizer, str):
            optimizer_params = dict(optimizer_params)
            optimizer_params.setdefault("rescale_grad", rescale_grad)
            optimizer = opt_mod.create(optimizer, param_idx2name=idx2name,
                                       sym=self.symbol, **optimizer_params)
        else:
            if optimizer.rescale_grad != rescale_grad:
                self.logger.warning(
                    "Optimizer created manually outside Module but "
                    "rescale_grad != 1.0/batch_size (%s vs %s)",
                    optimizer.rescale_grad, rescale_grad)
            optimizer.idx2name = idx2name.copy()
        self._optimizer = optimizer
        self._kvstore = kvstore
        self._update_on_kvstore = update_on_kvstore
        self._updater = None
        if kvstore:
            _initialize_kvstore(kvstore=kvstore,
                                param_arrays=self._exec_group.param_arrays,
                                arg_params=self._arg_params,
                                param_names=self._exec_group.param_names,
                                update_on_kvstore=update_on_kvstore)
        if update_on_kvstore:
            kvstore.set_optimizer(self._optimizer)
        else:
            self._updater = opt_mod.get_updater(optimizer)
        self.optimizer_initialized = True
        preload = self.__dict__.pop("_preload_opt_states", None)
        if preload is not None:
            if not os.path.exists(preload):
                raise MXNetError("no optimizer states at %s" % preload)
            self.load_optimizer_states(preload)

    def borrow_optimizer(self, shared_module):
        """Use ``shared_module``'s optimizer and updater (its states
        too), for a module bound with ``shared_module``: the updater
        keys states by parameter index, so both must list the same
        parameters in the same order."""
        if not shared_module.optimizer_initialized:
            raise MXNetError("shared module has no optimizer")
        if self._exec_group.param_names != \
                shared_module._exec_group.param_names:
            raise MXNetError("borrow_optimizer: the modules' parameters "
                             "differ")
        self._optimizer = shared_module._optimizer
        self._kvstore = shared_module._kvstore
        self._update_on_kvstore = shared_module._update_on_kvstore
        self._updater = shared_module._updater
        self.optimizer_initialized = True

    # -- execution ----------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        """Copy the batch in and run the graph; an inference batch of
        another shape goes through the bucketed forward when it can,
        else the module rebinds first (the parameters carried over)."""
        if not (self.binded and self.params_initialized):
            raise MXNetError("bind() and init_params() first")
        curr_shapes = [d.shape for d in self._exec_group.data_shapes]
        new_shapes = [tuple(a.shape) for a in data_batch.data]
        train = self.for_training if is_train is None else is_train
        if curr_shapes != new_shapes and not train \
                and self._exec_group.can_forward_ragged(data_batch):
            try:
                self._exec_group.forward_ragged(data_batch)
                return
            except Exception:
                self.logger.debug("bucketed forward failed; rebinding",
                                  exc_info=True)
        if curr_shapes != new_shapes:
            new_dshapes = [DataDesc(d.name, s) for d, s in
                           zip(self._exec_group.data_shapes, new_shapes)]
            new_lshapes = None
            if getattr(data_batch, "label", None):
                new_lshapes = [DataDesc(n, tuple(a.shape)) for n, a in
                               zip(self._label_names, data_batch.label)]
            self.reshape(new_dshapes, new_lshapes)
        self._exec_group.forward(data_batch, is_train)

    def reshape(self, data_shapes, label_shapes=None):
        """Rebind at other shapes, the parameters carried over; a
        monitor follows the new executors."""
        self._sync_params_from_devices()
        old = set(map(id, self._exec_group.execs)) \
            if self._exec_group else set()
        arg_p, aux_p = self._arg_params, self._aux_params
        self.bind(data_shapes, label_shapes, for_training=self.for_training,
                  inputs_need_grad=self.inputs_need_grad, force_rebind=True)
        if arg_p is not None:
            self._exec_group.set_params(arg_p, aux_p)
        if self._monitor is not None:
            self._monitor.exes = [e for e in self._monitor.exes
                                  if id(e) not in old]
            self._exec_group.install_monitor(self._monitor)

    def warmup(self):
        """Run the bound executors' graphs once on zeros
        (``Executor.warmup``)."""
        if not self.binded:
            raise MXNetError("bind() first")
        self._exec_group.warmup()
        return self

    def backward(self, out_grads=None):
        if not (self.binded and self.params_initialized):
            raise MXNetError("bind() and init_params() first")
        self._exec_group.backward(out_grads=out_grads)

    def update(self):
        """Apply the optimizer to the gradients of the last backward."""
        if not (self.binded and self.params_initialized and
                self.optimizer_initialized):
            raise MXNetError("init_optimizer() first")
        self._params_dirty = True
        g = self._exec_group
        if self._update_on_kvstore:
            _update_params_on_kvstore(g.param_arrays, g.grad_arrays,
                                      self._kvstore, g.param_names)
        else:
            _update_params(g.param_arrays, g.grad_arrays,
                           updater=self._updater,
                           num_device=len(self._context),
                           kvstore=self._kvstore, param_names=g.param_names)

    def get_outputs(self, merge_multi_context=True):
        return self._exec_group.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        if not self.inputs_need_grad:
            raise MXNetError("bind with inputs_need_grad=True")
        return self._exec_group.get_input_grads(merge_multi_context)

    def install_monitor(self, mon):
        if not self.binded:
            raise MXNetError("bind() first")
        self._monitor = mon
        self._exec_group.install_monitor(mon)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        self._exec_group.update_metric(eval_metric, labels, pre_sliced)
