"""Operators of the PyTorch port (counterpart of ``mxtpu/ops/``).

Flash attention, forward and backward, is hand-written CUDA
(``mxtpu/ops/pallas_attention.py`` -> :mod:`.flash_attention`).  The
registry (:mod:`.registry`) holds the ops the symbolic and imperative
layers call: the ResNet set (:mod:`.nn`), the recurrent ``RNN`` op
(:mod:`.rnn_op`, cuDNN on the card) and ``Embedding``
(:mod:`.indexing`), the elementwise, shape, reduction, initialization,
random and optimizer-update ops they need.
"""
from . import registry
from . import elemwise
from . import flash_attention
from . import indexing
from . import init_ops
from . import matrix
from . import nn
from . import optimizer_ops
from . import random_ops
from . import reduce
from . import rnn_op

__all__ = ["registry", "elemwise", "flash_attention", "indexing",
           "init_ops", "matrix", "nn", "optimizer_ops", "random_ops",
           "reduce", "rnn_op"]
