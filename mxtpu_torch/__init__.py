"""mxtpu_torch: the PyTorch/CUDA port of mxtpu, for one NVIDIA H100.

Counterpart of ``mxtpu/__init__.py``.  The port imports ``torch``, numpy
and the standard library, never JAX and nothing of ``mxtpu``.  Its entry
points run on the card unless the caller passes ``device="cpu"``.

Ported so far: serving and training the TransformerLM on one device --
``serve`` (the continuous micro-batcher), ``parallel`` (mesh names, the
sp=1 ring-attention route, the transformer forward, loss, Adam/SGD
train steps), ``executor`` (remat policies) and ``ops`` (flash
attention: hand-written CUDA kernels for sm_90a, forward and backward).
"""
from . import base
from .base import MXNetError, MemoryExhaustedError, RequestShedError
from . import context
from .context import cpu, gpu
from . import executor
from . import ops
from . import parallel
from . import serve

__all__ = ["base", "context", "cpu", "gpu", "executor", "ops", "parallel",
           "serve",
           "MXNetError", "MemoryExhaustedError", "RequestShedError"]
