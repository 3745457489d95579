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
not written, and is not needed to read one.
"""
from __future__ import annotations

from collections import namedtuple

import numpy as np

from .base import MXNetError
from .ndarray import ndarray as nd_mod
from . import kvstore as kvs
from . import symbol as sym_mod

__all__ = ["BatchEndParam", "save_checkpoint", "load_checkpoint"]

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
