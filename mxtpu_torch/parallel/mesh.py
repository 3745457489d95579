"""Device meshes of the PyTorch port.

Counterpart of ``mxtpu/parallel/mesh.py``: the axis vocabulary
(canonical order, outermost first: dp, pp, tp, sp, ep),
``default_mesh_shape``, ``create_mesh``, ``current_mesh``,
``MeshContext`` and ``axis_size``.

A :class:`Mesh` is an object array of ``torch.device``s shaped by the
axis sizes, with the axis names, as ``jax.sharding.Mesh`` is.  One
controller drives every shard (:mod:`.spmd`), so a device may appear
more than once: ``[torch.device("cuda", 0)] * 16`` is a 16-shard mesh
on one card, ``[torch.device("cpu")] * 8`` the CPU tests' mesh.  The
default device list is every visible card; there is no fallback to the
CPU.  A mesh with every axis at 1 is one device: the entry points hand
out plain tensors on it.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..base import MXNetError
from ..context import resolve

__all__ = ["AXIS_DP", "AXIS_PP", "AXIS_TP", "AXIS_SP", "AXIS_EP", "Mesh",
           "create_mesh", "default_mesh_shape", "current_mesh",
           "MeshContext", "axis_size"]

AXIS_DP = "dp"
AXIS_TP = "tp"
AXIS_PP = "pp"
AXIS_SP = "sp"
AXIS_EP = "ep"

_CANONICAL_ORDER = (AXIS_DP, AXIS_PP, AXIS_TP, AXIS_SP, AXIS_EP)

_state = threading.local()


class Mesh(object):
    """``devices``: an object array of ``torch.device``s whose axes are
    ``axis_names``; ``shape`` maps each name to its size, in order."""

    def __init__(self, devices, axis_names: Sequence[str]):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise MXNetError("mesh of %d axes named %r"
                             % (self.devices.ndim, self.axis_names))
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        # coordinates in row-major order: the order of every shard list
        self.coords = list(np.ndindex(*self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device(self) -> torch.device:
        """The first device: a one-device mesh's device."""
        return self.devices.flat[0]

    def device_at(self, coord) -> torch.device:
        return self.devices[tuple(coord)]

    def axis_position(self, name: str) -> int:
        if name not in self.shape:
            raise MXNetError("mesh has no axis %r (axes %r)"
                             % (name, self.axis_names))
        return self.axis_names.index(name)

    def _key(self):
        return self.axis_names, tuple(self.devices.shape), \
            tuple(self.devices.flat)

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        devs = sorted({str(d) for d in self.devices.flat})
        return "Mesh(%s, devices %s)" % (
            ", ".join("%s=%d" % kv for kv in self.shape.items()),
            ", ".join(devs))


def default_mesh_shape(n_devices: int, tp: int = 1, pp: int = 1,
                       sp: int = 1, ep: int = 1) -> Dict[str, int]:
    """Factor n_devices into a mesh shape; dp absorbs the remainder."""
    denom = tp * pp * sp * ep
    if denom <= 0 or n_devices % denom != 0:
        raise MXNetError(
            "cannot factor %d devices into tp=%d pp=%d sp=%d ep=%d"
            % (n_devices, tp, pp, sp, ep))
    return {AXIS_DP: n_devices // denom, AXIS_PP: pp, AXIS_TP: tp,
            AXIS_SP: sp, AXIS_EP: ep}


def _visible_cards():
    """Every visible card; raises when there is none."""
    resolve(torch.device("cuda"))
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def create_mesh(shape: Optional[Dict[str, int]] = None,
                devices: Optional[Sequence] = None,
                axis_order: Optional[Sequence[str]] = None) -> Mesh:
    """A mesh of ``shape`` over ``devices`` (default: every visible card;
    a device may repeat; None in the list is the default device).
    Without a shape, every device goes to dp.  The canonical axes absent
    from ``shape`` are added at size 1, so lookups by any axis name
    resolve; the axes follow ``axis_order``, else the canonical order,
    then any other names."""
    devices = _visible_cards() if devices is None else list(devices)
    devices = [resolve(d) for d in devices]
    if shape is None:
        shape = default_mesh_shape(len(devices))
    full = {a: 1 for a in _CANONICAL_ORDER}
    full.update({a: int(n) for a, n in shape.items()})
    order = list(axis_order) if axis_order is not None else \
        [a for a in _CANONICAL_ORDER if a in full]
    order += [a for a in full if a not in order]
    sizes = [full[a] for a in order]
    total = int(np.prod(sizes))
    if total != len(devices):
        raise MXNetError("mesh shape %r needs %d devices, have %d"
                         % (dict(shape), total, len(devices)))
    arr = np.empty(total, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(sizes), order)


def current_mesh() -> Optional[Mesh]:
    """Innermost active mesh (set with `MeshContext`), or None."""
    stack = getattr(_state, "stack", None)
    return stack[-1] if stack else None


class MeshContext(object):
    """``with MeshContext(mesh):``: the mesh the collectives and
    :func:`axis_size` resolve when none is passed."""

    def __init__(self, mesh: Mesh):
        self._mesh = mesh

    def __enter__(self):
        if not hasattr(_state, "stack"):
            _state.stack = []
        _state.stack.append(self._mesh)
        return self._mesh

    def __exit__(self, *exc):
        _state.stack.pop()
        return False


def axis_size(axis_name: str, mesh: Optional[Mesh] = None) -> int:
    """Size of a named mesh axis of ``mesh``, else of the current mesh
    (the JAX package reads it from the enclosing shard_map)."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        raise MXNetError("axis_size(%r): no mesh; pass mesh= or enter a "
                         "MeshContext" % (axis_name,))
    return mesh.shape[axis_name]
