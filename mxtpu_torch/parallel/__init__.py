"""Parallel subsystem of the PyTorch port (counterpart of
``mxtpu/parallel/``), on one device so far: mesh axis names, the sp=1
ring-attention route and the TransformerLM forward and training."""
from . import mesh
from . import ring_attention
from . import transformer
from .mesh import (AXIS_DP, AXIS_EP, AXIS_PP, AXIS_SP, AXIS_TP,
                   create_mesh)

__all__ = ["mesh", "ring_attention", "transformer", "create_mesh",
           "AXIS_DP", "AXIS_PP", "AXIS_TP", "AXIS_SP", "AXIS_EP"]
