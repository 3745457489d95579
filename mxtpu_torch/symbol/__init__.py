"""``mxtpu_torch.sym``: the symbolic API (counterpart of
``mxtpu/symbol/``).  Every registered op is attached as a composer.

``zoo/resnet50_v1-symbol.json`` is the JAX package's own export of
ResNet-50 v1 (``vision.resnet50_v1(classes=1000)`` traced by
``_trace_symbol`` with a ``SoftmaxOutput(name="softmax")`` head, as
``bench.py`` builds it); ``tests/test_torch_symbol.py`` holds it to a
fresh trace.  The port loads it with ``sym.load(ZOO["resnet50_v1"])``
until its gluon can trace the model itself.
"""
import os as _os
import sys as _sys

from .symbol import (Symbol, Variable, var, Group, load, load_json,
                     NameManager)
from . import op_meta  # noqa: F401
from . import register as _register_mod

_this = _sys.modules[__name__]
_register_mod._init_symbol_module(_this)

ZOO = {"resnet50_v1": _os.path.join(_os.path.dirname(__file__), "zoo",
                                    "resnet50_v1-symbol.json")}
