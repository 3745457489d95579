"""mxtpu_torch: the PyTorch/CUDA port of mxtpu, for one NVIDIA H100.

Counterpart of ``mxtpu/__init__.py``.  The port imports ``torch``, numpy
and the standard library, never JAX and nothing of ``mxtpu``.  Its entry
points run on the card unless the caller passes ``device="cpu"``.

Ported so far: the serving path of the TransformerLM forward --
``serve`` (the continuous micro-batcher), ``parallel`` (mesh names, the
sp=1 ring-attention route, the transformer forward) and ``ops`` (the
flash-attention forward, a hand-written CUDA kernel for sm_90a).
"""
from . import base
from .base import MXNetError, MemoryExhaustedError, RequestShedError
from . import context
from .context import cpu, gpu
from . import ops
from . import parallel
from . import serve

__all__ = ["base", "context", "cpu", "gpu", "ops", "parallel", "serve",
           "MXNetError", "MemoryExhaustedError", "RequestShedError"]
