"""Parallel subsystem of the PyTorch port (counterpart of
``mxtpu/parallel/``): device meshes over several devices (repeated ones
too), the one-controller SPMD machinery (:mod:`.spmd`), the eager
collectives, ring attention over the flash kernels, and the
TransformerLM's dp x pp x tp x sp x ep forward and training."""
from . import mesh
from . import spmd
from . import collectives
from . import ring_attention
from . import transformer
from .mesh import (create_mesh, default_mesh_shape, MeshContext,
                   current_mesh, AXIS_DP, AXIS_TP, AXIS_PP, AXIS_SP,
                   AXIS_EP)
from .collectives import (all_reduce, all_gather, reduce_scatter,
                          all_to_all, collective_permute, psum_scalar)
from .ring_attention import ring_attention, blockwise_attention
from .transformer import TransformerConfig

__all__ = [
    "create_mesh", "default_mesh_shape", "MeshContext", "current_mesh",
    "AXIS_DP", "AXIS_TP", "AXIS_PP", "AXIS_SP", "AXIS_EP",
    "all_reduce", "all_gather", "reduce_scatter", "all_to_all",
    "collective_permute", "psum_scalar",
    "ring_attention", "blockwise_attention",
    "transformer", "TransformerConfig", "mesh", "spmd", "collectives",
]
