"""Model helpers of the PyTorch port (counterpart of part of
``mxtpu/model.py``): the kvstore decision, ``_update_params``,
``BatchEndParam`` and ``save_checkpoint``/``load_checkpoint`` in the JAX
package's format (``prefix-symbol.json`` and ``prefix-%04d.params``
with ``arg:``/``aux:`` keys).

The kvstore is not ported (ROADMAP A15): on one device a kvstore name
without ``dist`` other than ``tpu`` (``local``, ``device``), or none,
means none, as in the JAX package; anything else raises.
The CRC manifest of the JAX package's atomic checkpoints is not
written, and is not needed to read one.
"""
from __future__ import annotations

from collections import namedtuple

from .base import MXNetError
from .ndarray import ndarray as nd_mod
from . import symbol as sym_mod

__all__ = ["BatchEndParam", "save_checkpoint", "load_checkpoint"]

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])


def _create_kvstore(kvstore, num_device: int, arg_params):
    """(kvstore, update_on_kvstore): (None, False) for no kvstore, and on
    one device for any kvstore name without ``dist`` other than ``tpu``
    (``local``, ``device``...), as in the JAX package; the port has no
    kvstore for anything else."""
    if kvstore is None or kvstore == "":
        return None, False
    if isinstance(kvstore, str) and num_device == 1 \
            and "dist" not in kvstore and kvstore != "tpu":
        return None, False
    raise MXNetError("kvstore %r over %d device(s) is not ported (ROADMAP "
                     "A15): use one device with kvstore='local'"
                     % (kvstore, num_device))


def _update_params(param_arrays, grad_arrays, updater, num_device,
                   kvstore=None, param_names=None):
    """Run the updater on each device's (index, grad, weight) triples,
    all of a device's parameters in one ``update_multi``."""
    if kvstore is not None:
        raise MXNetError("kvstore aggregation is not ported (ROADMAP A15)")
    updates = [[] for _ in range(num_device)]
    for i, (arg_list, grad_list) in enumerate(zip(param_arrays,
                                                  grad_arrays)):
        if grad_list[0] is None:
            continue
        for k, (w, g) in enumerate(zip(arg_list, grad_list)):
            updates[k].append((i * num_device + k, g, w))
    for dev_updates in updates:
        updater.update_multi(dev_updates)


def save_checkpoint(prefix: str, epoch: int, symbol, arg_params,
                    aux_params):
    """Write ``prefix-symbol.json`` and ``prefix-%04d.params``."""
    if symbol is not None:
        symbol.save("%s-symbol.json" % prefix)
    save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
    save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
    nd_mod.save("%s-%04d.params" % (prefix, epoch), save_dict)


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
