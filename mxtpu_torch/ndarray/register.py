"""Attach every registered op as a function of ``mxtpu_torch.nd``
(counterpart of ``mxtpu/ndarray/register.py``): ``nd.elemwise_add(a,
b)``, ``nd.FullyConnected(x, w, b, num_hidden=...)``, with ``out=``."""
from __future__ import annotations

import sys
import types

from ..ops import registry as _reg
from .ndarray import imperative_invoke


def _make_ndarray_function(name: str, opdef):
    def fn(*args, out=None, name=None, **kwargs):  # noqa: A002 - parity
        res = imperative_invoke(opdef.name, *args, out=out, **kwargs)
        return res[0] if len(res) == 1 else list(res)

    fn.__name__ = name
    fn.__doc__ = opdef.doc
    fn.__module__ = "mxtpu_torch.ndarray"
    return fn


def _init_op_module(target_module):
    for name, opdef in list(_reg._OP_REGISTRY.items()):
        setattr(target_module, name, _make_ndarray_function(name, opdef))
    _reg.add_post_register_hook(
        lambda n, od: setattr(target_module, n,
                              _make_ndarray_function(n, od)))


def prefix_namespace(target_module, prefix, name):
    """A sub-module ``target_module.<name>`` holding the functions of
    ``target_module`` whose names start with ``prefix``, without it
    (``nd.contrib.flash_attention``); kept in step with later
    registrations.  Used by ``nd`` and ``sym`` alike."""
    ns = types.ModuleType(target_module.__name__ + "." + name)

    def alias(op_name, _opdef=None):
        if op_name.startswith(prefix):
            setattr(ns, op_name[len(prefix):], getattr(target_module,
                                                       op_name))

    for op_name in list(_reg._OP_REGISTRY):
        alias(op_name)
    _reg.add_post_register_hook(alias)
    sys.modules[ns.__name__] = ns
    return ns
