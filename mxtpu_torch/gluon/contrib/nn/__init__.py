"""Experimental layers (counterpart of ``mxtpu/gluon/contrib/nn/``)."""
from . import basic_layers  # noqa: F401
from .basic_layers import (Concurrent, HybridConcurrent, Identity,  # noqa: F401
                           PixelShuffle2D, SparseEmbedding,
                           SyncBatchNorm)
