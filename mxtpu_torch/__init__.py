"""mxtpu_torch: the PyTorch/CUDA port of mxtpu, for one NVIDIA H100.

Counterpart of ``mxtpu/__init__.py``.  The port imports ``torch``, numpy
and the standard library, never JAX and nothing of ``mxtpu``.  Its entry
points run on the card unless the caller passes ``mx.cpu()`` or
``device="cpu"``.

Ported so far:

* serving and training the TransformerLM on one device: ``serve`` (the
  continuous micro-batcher), ``parallel`` (mesh names, the sp=1
  ring-attention route, the transformer forward, loss, Adam/SGD train
  steps) and flash attention (``ops.flash_attention``: hand-written CUDA
  kernels for sm_90a, forward and backward);
* the symbolic training stack on one device, enough to train ResNet-50
  v1 through ``sym`` and ``mod``: the op ``registry`` and the ResNet op
  set (``ops``), ``nd`` (NDArray), ``autograd``, ``random``, ``sym``
  (Symbol, JSON, shape inference), ``executor`` (Executor, remat),
  ``initializer``, ``optimizer`` (SGD, Adam), ``lr_scheduler``,
  ``model`` (checkpoints), ``io`` (DataBatch, NDArrayIter), ``mod``
  (Module) and ``metric``;
* bench.py's fused ResNet rows: ``FusedTrainLoop`` (K steps a call, a
  CUDA graph of the step on the card) and ``amp`` (the bfloat16 compute
  policy, applied per node by the executor);
* ``gluon`` (Parameter, Block and HybridBlock, whose ``hybridize()``
  runs the traced graph as one ``cached_op.CachedOp``, the ``nn``
  layers, the losses, the ResNets of the model zoo, Trainer), with the
  ``_contrib_flash_attention`` op reaching the attention kernels;
* the LSTM language model both ways: gluon's ``Embedding`` and
  ``rnn.LSTM`` over the fused ``RNN`` op (cuDNN on the card), and the
  symbolic cells of ``rnn`` unrolled per bucket under
  ``mod.BucketingModule`` (``rnn.BucketSentenceIter``,
  ``metric.Perplexity``, ``callback``).
"""
from . import base
from .base import MXNetError, MemoryExhaustedError, RequestShedError
from . import context
from .context import cpu, gpu, current_context
from . import ops
from . import amp
from . import autograd
from . import random
from . import ndarray
from . import ndarray as nd
from . import symbol
from . import symbol as sym
from . import executor
from . import initializer
from . import initializer as init
from . import optimizer
from . import lr_scheduler
from . import model
from . import io
from . import metric
from . import callback
from . import module
from . import module as mod
from . import cached_op
from . import gluon
from . import rnn
from . import parallel
from . import serve
from .fused_train import FusedTrainLoop

__all__ = ["base", "context", "cpu", "gpu", "current_context", "ops",
           "amp", "autograd", "random", "ndarray", "nd", "symbol", "sym",
           "executor", "initializer", "init", "optimizer", "lr_scheduler",
           "model", "io", "metric", "callback", "module", "mod",
           "cached_op", "gluon", "rnn", "parallel", "serve",
           "FusedTrainLoop",
           "MXNetError", "MemoryExhaustedError", "RequestShedError"]
