"""BaseModule of the PyTorch port: the high-level train and predict
loop (counterpart of ``fit``, ``score``, ``predict``,
``forward_backward`` and ``set_params`` in
``mxtpu/module/base_module.py``)."""
from __future__ import annotations

import logging
import time

from ..base import MXNetError
from .. import metric as metric_mod
from ..model import BatchEndParam
from ..ndarray.ndarray import NDArray

__all__ = ["BaseModule"]


def _as_list(x):
    if x is None:
        return []
    return x if isinstance(x, (list, tuple)) else [x]


class BaseModule(object):
    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.inputs_need_grad = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None

    @property
    def symbol(self):
        return self._symbol

    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, reset=True, epoch=0):
        """Evaluate ``eval_metric`` over ``eval_data``."""
        if not (self.binded and self.params_initialized):
            raise MXNetError("bind() and init_params() first")
        eval_metric = metric_mod.create(eval_metric)
        eval_metric.reset()
        if reset:
            eval_data.reset()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            for cb in _as_list(batch_end_callback):
                cb(BatchEndParam(epoch=epoch, nbatch=nbatch,
                                 eval_metric=eval_metric, locals=locals()))
        return eval_metric.get_name_value()

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False):
        """The outputs over ``eval_data``, the padding of the last batch
        dropped, concatenated over batches."""
        import torch

        if not (self.binded and self.params_initialized):
            raise MXNetError("bind() and init_params() first")
        if reset:
            eval_data.reset()
        output_list = []
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad or 0
            output_list.append([NDArray(out._data[:out.shape[0] - pad].clone())
                                for out in self.get_outputs()])
        if not output_list or not merge_batches:
            return output_list
        merged = [NDArray(torch.cat([out[i]._data for out in output_list]))
                  for i in range(len(output_list[0]))]
        if len(merged) == 1 and not always_output_list:
            return merged[0]
        return merged

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", optimizer="sgd",
            optimizer_params=(("learning_rate", 0.01),),
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None):
        """The training loop: bind, init_params, init_optimizer, then
        forward/backward/update over ``train_data`` each epoch."""
        from ..initializer import Uniform

        if num_epoch is None:
            raise MXNetError("num_epoch required for fit")
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        self.init_params(initializer=initializer or Uniform(0.01),
                         arg_params=arg_params, aux_params=aux_params,
                         allow_missing=allow_missing, force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=dict(optimizer_params),
                            force_init=force_init)
        validation_metric = validation_metric or eval_metric
        eval_metric = metric_mod.create(eval_metric)
        for epoch in range(begin_epoch, num_epoch):
            tic = time.time()
            eval_metric.reset()
            for nbatch, data_batch in enumerate(train_data):
                self.forward_backward(data_batch)
                self.update()
                self.update_metric(eval_metric, data_batch.label)
                for cb in _as_list(batch_end_callback):
                    cb(BatchEndParam(epoch=epoch, nbatch=nbatch,
                                     eval_metric=eval_metric,
                                     locals=locals()))
            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                             time.time() - tic)
            arg_p, aux_p = self.get_params()
            for cb in _as_list(epoch_end_callback):
                cb(epoch, self.symbol, arg_p, aux_p)
            if eval_data is not None:
                for name, val in self.score(eval_data, validation_metric,
                                            epoch=epoch):
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch,
                                     name, val)
            train_data.reset()

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init, allow_extra=allow_extra)
