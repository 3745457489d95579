"""Model helpers of the PyTorch port (counterpart of part of
``mxtpu/model.py``): the kvstore decision and the updates through a
store (``_create_kvstore``, ``_initialize_kvstore``,
``_update_params_on_kvstore``, ``_update_params``), ``BatchEndParam``
and ``save_checkpoint``/``load_checkpoint`` in the JAX package's format
(``prefix-symbol.json`` and ``prefix-%04d.params`` with
``arg:``/``aux:`` keys, and the optimizer's pickled states as
``prefix-%04d.states``).

The kvstore rule is the JAX package's: none for no name, and on one
device for a name without ``dist`` other than ``tpu`` (``local``,
``device``); a store object is used as it is; any other name makes its
store (``dist_sync``, ``dist_async``...), with the optimizer on the
store unless a ``local`` store's largest parameter passes 16M
elements.  The CRC manifest of the JAX package's atomic checkpoints is
not written, and is not needed to read one (reading it,
``read_checkpoint_meta``, comes with A17).

``FeedForward`` is the legacy estimator over ``module.Module``:
``fit``/``predict``/``score`` on data iterators, ``save``/``load`` of
checkpoints, on ``ctx`` (default: the current context).
"""
from __future__ import annotations

from collections import namedtuple

import numpy as np

from .base import MXNetError
from .context import current_context
from .ndarray import ndarray as nd_mod
from . import kvstore as kvs
from . import symbol as sym_mod

__all__ = ["BatchEndParam", "save_checkpoint", "load_checkpoint",
           "FeedForward"]

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])


def _create_kvstore(kvstore, num_device: int, arg_params):
    """(kvstore, update_on_kvstore) for a store name or object."""
    update_on_kvstore = True
    if kvstore is None or kvstore == "":
        kv = None
    elif isinstance(kvstore, kvs.KVStore):
        kv = kvstore
    elif isinstance(kvstore, str):
        if num_device == 1 and "dist" not in kvstore and kvstore != "tpu":
            kv = None
        else:
            kv = kvs.create(kvstore)
            if kvstore == "local":
                # a model with a parameter of more than 16M elements
                # updates on each device, not on the merge device
                max_size = max(int(np.prod(p.shape)) for p in
                               arg_params.values()) if arg_params else 0
                if max_size > 1024 * 1024 * 16:
                    update_on_kvstore = False
    else:
        raise MXNetError("bad kvstore %r" % (kvstore,))
    if kv is None:
        update_on_kvstore = False
    return kv, update_on_kvstore


def _initialize_kvstore(kvstore, param_arrays, arg_params, param_names,
                        update_on_kvstore):
    for idx, param_on_devs in enumerate(param_arrays):
        name = param_names[idx]
        kvstore.init(name, arg_params[name])
        if update_on_kvstore:
            kvstore.pull(name, param_on_devs, priority=-idx)


def _update_params_on_kvstore(param_arrays, grad_arrays, kvstore,
                              param_names):
    """Push each gradient and pull the weight the store updated."""
    for index, (arg_list, grad_list) in enumerate(zip(param_arrays,
                                                      grad_arrays)):
        if grad_list[0] is None:
            continue
        name = param_names[index]
        kvstore.push(name, grad_list, priority=-index)
        kvstore.pull(name, arg_list, priority=-index)


def _update_params(param_arrays, grad_arrays, updater, num_device,
                   kvstore=None, param_names=None):
    """Sum each gradient through the store when there is one (push,
    then pull into the gradients), then run the updater on each
    device's (index, grad, weight) triples, all of a device's
    parameters in one ``update_multi``."""
    updates = [[] for _ in range(num_device)]
    for i, (arg_list, grad_list) in enumerate(zip(param_arrays,
                                                  grad_arrays)):
        if grad_list[0] is None:
            continue
        if kvstore:
            kvstore.push(param_names[i], grad_list, priority=-i)
            kvstore.pull(param_names[i], grad_list, priority=-i)
        for k, (w, g) in enumerate(zip(arg_list, grad_list)):
            updates[k].append((i * num_device + k, g, w))
    for dev_updates in updates:
        updater.update_multi(dev_updates)


def save_checkpoint(prefix: str, epoch: int, symbol, arg_params,
                    aux_params, states=None):
    """Write ``prefix-symbol.json``, ``prefix-%04d.params`` and, given
    ``states`` (bytes), ``prefix-%04d.states``."""
    if symbol is not None:
        symbol.save("%s-symbol.json" % prefix)
    save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
    save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
    nd_mod.save("%s-%04d.params" % (prefix, epoch), save_dict)
    if states is not None:
        with open("%s-%04d.states" % (prefix, epoch), "wb") as f:
            f.write(states)


def load_checkpoint(prefix: str, epoch: int, ctx=None):
    """(symbol, arg_params, aux_params), the arrays on ``ctx`` (default:
    the card)."""
    symbol = sym_mod.load("%s-symbol.json" % prefix)
    save_dict = nd_mod.load("%s-%04d.params" % (prefix, epoch), ctx=ctx)
    arg_params, aux_params = {}, {}
    for k, v in save_dict.items():
        tp, _, name = k.partition(":")
        if tp == "arg":
            arg_params[name] = v
        elif tp == "aux":
            aux_params[name] = v
    return symbol, arg_params, aux_params


class FeedForward(object):
    """The legacy estimator: a ``Module`` made at ``fit`` from the data
    iterator's names, trained for ``num_epoch`` epochs (1 when None)
    with ``optimizer`` and ``initializer`` (``Uniform(0.01)`` when
    None), from ``arg_params``/``aux_params`` when given."""

    def __init__(self, symbol, ctx=None, num_epoch=None, epoch_size=None,
                 optimizer="sgd", initializer=None, numpy_batch_size=128,
                 arg_params=None, aux_params=None, begin_epoch=0,
                 **kwargs):
        from .initializer import Uniform

        self.symbol = symbol
        self.ctx = list(ctx) if isinstance(ctx, (list, tuple)) else \
            [ctx or current_context()]
        self.num_epoch = num_epoch
        self.epoch_size = epoch_size
        self.optimizer = optimizer
        self.initializer = initializer or Uniform(0.01)
        self.numpy_batch_size = numpy_batch_size
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.begin_epoch = begin_epoch
        self.kwargs = kwargs
        self._module = None

    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", logger=None, optimizer_params=None):
        from .module import Module

        mod = Module(self.symbol,
                     data_names=[d[0] for d in X.provide_data],
                     label_names=[l[0] for l in X.provide_label],
                     context=self.ctx)
        mod.fit(X, eval_data=eval_data, eval_metric=eval_metric,
                epoch_end_callback=epoch_end_callback,
                batch_end_callback=batch_end_callback, kvstore=kvstore,
                optimizer=self.optimizer,
                optimizer_params=optimizer_params or
                {"learning_rate": 0.01},
                initializer=self.initializer,
                arg_params=self.arg_params, aux_params=self.aux_params,
                begin_epoch=self.begin_epoch,
                num_epoch=self.num_epoch or 1)
        self._module = mod
        self.arg_params, self.aux_params = mod.get_params()
        return self

    def predict(self, X, num_batch=None):
        """The outputs over ``X`` as numpy arrays (one array for one
        output)."""
        if self._module is None:
            raise MXNetError("fit() first")
        outs = self._module.predict(X, num_batch=num_batch)
        return outs.asnumpy() if not isinstance(outs, list) else \
            [o.asnumpy() for o in outs]

    def score(self, X, eval_metric="acc", num_batch=None):
        """The metric's value over ``X``."""
        if self._module is None:
            raise MXNetError("fit() first")
        return self._module.score(X, eval_metric, num_batch=num_batch)[0][1]

    def save(self, prefix, epoch=None):
        save_checkpoint(prefix, epoch if epoch is not None else
                        (self.num_epoch or 0), self.symbol,
                        self.arg_params or {}, self.aux_params or {})

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        """A FeedForward from a checkpoint, to train on from ``epoch``."""
        symbol, arg_params, aux_params = load_checkpoint(
            prefix, epoch, ctx=ctx[0] if isinstance(ctx, (list, tuple))
            else ctx)
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch,
                           **kwargs)
