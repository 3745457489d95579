"""ZeRO-1's memory accounting; the updater waits for several contexts.

Counterpart of ``mxtpu/sharding/zero1.py``: ``tree_nbytes`` and
``state_nbytes``.  ``ZeRO1Updater`` (Module's and Trainer's updater over
a context list) comes with A15c, ``hbm_report`` with ``mx.hbm`` (A18);
both raise.  The transformer's SPMD step has its own ZeRO-1 Adam
(``parallel/transformer.py``).
"""
from __future__ import annotations

from typing import Any

import numpy as np

from ..base import MXNetError
from ..ndarray.ndarray import NDArray

__all__ = ["ZeRO1Updater", "hbm_report", "state_nbytes", "tree_nbytes"]


def tree_nbytes(obj) -> int:
    """Payload bytes of a (nested) optimizer state: NDArrays, tensors,
    sharded values (their global bytes, as a sharded ``jax.Array``'s
    ``nbytes``), and tuples, lists or dicts of them."""
    if obj is None:
        return 0
    if isinstance(obj, NDArray):
        return int(obj.size) * obj._data.element_size()
    if isinstance(obj, (tuple, list)):
        return sum(tree_nbytes(o) for o in obj)
    if isinstance(obj, dict):
        return sum(tree_nbytes(o) for o in obj.values())
    if hasattr(obj, "nbytes"):
        return int(obj.nbytes)
    if hasattr(obj, "shape") and hasattr(obj, "dtype"):
        return int(np.prod(obj.shape)) * np.dtype(obj.dtype).itemsize
    return 0


def state_nbytes(updater) -> int:
    """Optimizer-state bytes held by an ``optimizer.Updater``."""
    return tree_nbytes(getattr(updater, "states", None))


class ZeRO1Updater(object):
    """Module's and Trainer's ZeRO-1 updater over several contexts."""

    def __init__(self, *args, **kwargs):
        raise MXNetError("ZeRO1Updater (ZeRO-1 over a context list) is not "
                         "ported yet (ROADMAP A15c)")


def hbm_report(updater) -> Any:
    """The measured ZeRO-1 memory ledger joined with ``mx.hbm``'s plan."""
    raise MXNetError("hbm_report needs mx.hbm, which is not ported yet "
                     "(ROADMAP A18)")
