"""``mxtpu_torch.nd``: the imperative NDArray API (counterpart of
``mxtpu/ndarray/``).  Every registered op is attached as a function;
the ``_contrib_*`` ops also as ``nd.contrib.*`` without the prefix."""
import sys as _sys

from .ndarray import (NDArray, imperative_invoke, array, zeros, ones, full,
                      waitall, save, load)
from . import register as _register_mod

_this = _sys.modules[__name__]
_register_mod._init_op_module(_this)
contrib = _register_mod.prefix_namespace(_this, "_contrib_", "contrib")

# creation helpers shadow same-named generated wrappers on purpose
_this.zeros = zeros
_this.ones = ones
_this.full = full

from .. import random as random  # noqa: E402
