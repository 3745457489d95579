"""Device-mesh names of the PyTorch port (one device).

Counterpart of ``mxtpu/parallel/mesh.py``: the axis vocabulary
(outermost first: dp, pp, tp, sp, ep) and ``create_mesh``.  The port
runs on one device, so a mesh has every axis at size 1; a shape with any
axis above 1 raises and names the ROADMAP item that brings multi-GPU
meshes (A15).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from ..base import MXNetError
from ..context import resolve

__all__ = ["AXIS_DP", "AXIS_PP", "AXIS_TP", "AXIS_SP", "AXIS_EP", "Mesh",
           "create_mesh"]

AXIS_DP = "dp"
AXIS_TP = "tp"
AXIS_PP = "pp"
AXIS_SP = "sp"
AXIS_EP = "ep"

_CANONICAL_ORDER = (AXIS_DP, AXIS_PP, AXIS_TP, AXIS_SP, AXIS_EP)


@dataclass(frozen=True)
class Mesh:
    """A one-device mesh: ``shape`` maps every axis name to 1."""
    shape: Dict[str, int]
    device: torch.device


def create_mesh(shape: Optional[Dict[str, int]] = None,
                device=None) -> Mesh:
    """A mesh over one device (``device``, default the card).  Every
    axis of ``shape`` must be 1; the canonical axes absent from it are
    added at size 1, so lookups by any axis name resolve."""
    shape = dict(shape or {})
    big = {a: int(n) for a, n in shape.items() if int(n) != 1}
    if big:
        raise MXNetError(
            "mesh %r spans more than one device; the PyTorch port runs "
            "on one device until multi-GPU meshes land (ROADMAP A15)"
            % (big,))
    full = {a: 1 for a in _CANONICAL_ORDER}
    full.update({a: 1 for a in shape})
    return Mesh(shape=full, device=resolve(device))
