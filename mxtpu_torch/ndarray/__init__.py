"""``mxtpu_torch.nd``: the imperative NDArray API (counterpart of
``mxtpu/ndarray/``).  Every registered op is attached as a function;
the ``_contrib_*`` and ``_linalg_*`` ops also as ``nd.contrib.*`` and
``nd.linalg.*`` without the prefix; the
sparse arrays are ``nd.sparse``."""
import sys as _sys

from .ndarray import (NDArray, imperative_invoke, array, zeros, ones, full,
                      empty, arange, eye, concat, stack, split, moveaxis,
                      maximum, minimum, from_numpy, from_dlpack,
                      to_dlpack_for_read, to_dlpack_for_write, waitall, save,
                      load)
from . import ndarray as _ndarray
from . import register as _register_mod

_this = _sys.modules[__name__]
_register_mod._init_op_module(_this)
contrib = _register_mod.prefix_namespace(_this, "_contrib_", "contrib")
linalg = _register_mod.prefix_namespace(_this, "_linalg_", "linalg")

# the helpers shadow same-named generated wrappers on purpose (the
# wrappers were set on this module, over the names imported above)
for _name in ("zeros", "ones", "full", "concat", "stack", "split"):
    setattr(_this, _name, getattr(_ndarray, _name))

from .. import random as random  # noqa: E402

# `nd.sparse` sub-namespace (reference: mxnet.ndarray.sparse)
from . import sparse  # noqa: E402
from .sparse import CSRNDArray, RowSparseNDArray  # noqa: E402
