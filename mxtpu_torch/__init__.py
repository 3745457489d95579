"""mxtpu_torch: the PyTorch/CUDA port of mxtpu, for one NVIDIA H100.

Counterpart of ``mxtpu/__init__.py``.  The port imports ``torch``, numpy
and the standard library, never JAX and nothing of ``mxtpu``.  Its entry
points run on the card unless the caller passes ``mx.cpu()`` (or
``device="cpu"``), or runs them under ``with mx.cpu():``.

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
  ``metric.Perplexity``, ``callback``);
* BASELINE config #5 in one process, sparse linear classification:
  ``nd.sparse`` (CSR and row-sparse arrays, the sparse ``dot`` whose
  weight gradient is row-sparse), ``io.LibSVMIter``, the lazy SGD and
  AdaGrad updates, and ``kv`` (the local KVStore with
  ``row_sparse_pull``); ``Embedding(sparse_grad=True)`` on the same
  machinery;
* the distributed stores ``dist_sync`` and ``dist_async``: the
  parameter server (``_ps``, ``kvstore_server``) and its launcher
  (``python -m mxtpu_torch.tools.launch``), with ``mod.Module`` and
  ``gluon.Trainer`` over a store, and ``io.MNISTIter``;
* the dense op corpus (the elementwise, reduction, shape, product,
  initialization, indexing and ordering ops), NDArray's and Symbol's
  methods, ``autograd.grad`` and ``autograd.Function``, and the model
  zoo's AlexNet, DenseNet, Inception v3, MobileNet v1/v2, SqueezeNet
  and VGG;
* the other optimizers, samplers, initializers, metrics and iterators;
  the nn and linalg ops with gluon's transposed convolutions, norms,
  activations, losses and recurrent cells;
* control flow: ``nd.contrib``/``sym.contrib``'s ``foreach``,
  ``while_loop`` and ``cond`` (``control_flow``, over the ops of
  ``ops.control_flow``); the image ops; and gluon's ``data`` (datasets,
  samplers, the DataLoader, the vision datasets and transforms) and
  ``contrib``;
* the detection ops; INT8 post-training quantization
  (``contrib.quantization``, on the ``subgraph`` framework, with its
  Conv+BN fold backend ``"TPU"``), the dgl graph ops, and the user's
  Python ops (``operator``, ``nd.Custom``/``sym.Custom``);
* ``Context`` with its ``with`` scope, ``cpu_pinned`` and
  ``cpu_shared``; the dependency ``engine``; ``libinfo``, ``log`` and
  ``util``; channels-last Convolution and Pooling; ``monitor``; the
  executor's ``reshape``, ``warmup`` and ragged inference; and
  ``model.FeedForward``;
* meshes over several devices (a device may repeat: one card can hold
  every shard), the eager collectives, ``sharding`` (``mx.shard``: the
  plan and ``reshard``), ring attention at sp > 1 on the flash kernels,
  and the TransformerLM's dp x pp x tp x sp step with ZeRO-1 Adam, one
  controller driving every shard (``parallel.spmd``).

Importing the package starts no parameter-server role, whatever
``MXTPU_ROLE`` says: a launched server or scheduler runs
``kvstore_server.init_module()``.
"""
from . import base
from .base import MXNetError, MemoryExhaustedError, RequestShedError
from . import context
from .context import (Context, cpu, gpu, cpu_pinned, cpu_shared, num_gpus,
                      current_context)
from . import engine
from . import log
from . import util
from . import libinfo
from . import ops
from . import amp
from . import autograd
from . import random
from .random import seed
from . import ndarray
from . import ndarray as nd
from .ndarray import NDArray
from . import symbol
from . import symbol as sym
from .symbol import Symbol, AttrScope
from . import name
from . import control_flow
# the front ends of MXNet's ``nd.contrib`` and ``sym.contrib``: one
# implementation that takes NDArrays or Symbols
for _ns in (ndarray.contrib, symbol.contrib):
    _ns.foreach = control_flow.foreach
    _ns.while_loop = control_flow.while_loop
    _ns.cond = control_flow.cond
del _ns
from . import executor
from .executor import Executor
from . import subgraph
from . import operator
from . import initializer
from . import initializer as init
from . import optimizer
from . import lr_scheduler
from . import model
from . import io
from . import kvstore
from . import kvstore as kv
from . import metric
from . import callback
from . import module
from . import module as mod
from . import cached_op
from .cached_op import CachedOp
from . import gluon
from . import rnn
from . import parallel
from . import sharding
from . import sharding as shard
from . import serve
from . import contrib
from . import monitor
from .fused_train import FusedTrainLoop

__all__ = ["base", "context", "Context", "cpu", "gpu", "cpu_pinned",
           "cpu_shared", "num_gpus", "current_context", "engine", "log",
           "util", "libinfo", "monitor", "ops",
           "amp", "autograd", "random", "seed", "ndarray", "nd", "NDArray",
           "symbol", "sym", "Symbol", "AttrScope", "name", "control_flow",
           "executor", "Executor", "subgraph", "operator", "contrib",
           "CachedOp", "initializer", "init",
           "optimizer", "lr_scheduler",
           "model", "io", "kvstore", "kv", "metric", "callback",
           "module", "mod",
           "cached_op", "gluon", "rnn", "parallel", "sharding", "shard",
           "serve",
           "FusedTrainLoop",
           "MXNetError", "MemoryExhaustedError", "RequestShedError"]
