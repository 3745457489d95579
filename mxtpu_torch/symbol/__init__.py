"""``mxtpu_torch.sym``: the symbolic API (counterpart of
``mxtpu/symbol/``).  Every registered op is attached as a composer; the
``_contrib_*`` ops also as ``sym.contrib.*`` without the prefix, and
``_zeros`` also as ``zeros`` (the recurrent cells' begin states).

``ZOO["resnet50_v1"]()`` is ResNet-50 v1 (1000 classes) as ``bench.py``
builds it: ``vision.resnet50_v1`` traced by the port's gluon
(``_trace_symbol``, in a fresh ``NameManager``, so its names are
``resnetv10_...`` whatever ran before) under a
``SoftmaxOutput(name="softmax")`` head.  ``tests/test_torch_symbol.py``
holds it, node for node, to the JAX package's trace.
"""
import sys as _sys

from .symbol import (Symbol, Variable, var, Group, load, load_json,
                     NameManager)
from . import op_meta  # noqa: F401
from . import register as _register_mod
from ..ndarray.register import prefix_namespace as _prefix_namespace

_this = _sys.modules[__name__]
_register_mod._init_symbol_module(_this)
contrib = _prefix_namespace(_this, "_contrib_", "contrib")
zeros = _this._zeros


def _resnet50_v1():
    from ..gluon.model_zoo import vision

    with NameManager():
        out, _, _ = vision.resnet50_v1(classes=1000)._trace_symbol(
            var("data0"))
        return _this.SoftmaxOutput(data=out,
                                   label=Variable("softmax_label"),
                                   name="softmax")


ZOO = {"resnet50_v1": _resnet50_v1}
