"""Operators of the PyTorch port (counterpart of ``mxtpu/ops/``).

Flash attention, forward and backward, is hand-written CUDA
(``mxtpu/ops/pallas_attention.py`` -> :mod:`.flash_attention`).  The
registry (:mod:`.registry`) holds the ops the symbolic and imperative
layers call: the dense corpus of :mod:`.elemwise`, :mod:`.reduce`,
:mod:`.matrix`, :mod:`.init_ops` and :mod:`.indexing`, the nn ops
(:mod:`.nn`), the linalg ops (:mod:`.linalg`), the recurrent ``RNN`` op
(:mod:`.rnn_op`, cuDNN on the card), the random and optimizer-update
ops the trainers need, the control-flow ops (:mod:`.control_flow`),
the image ops of gluon's transforms (:mod:`.image`), the detection
ops (:mod:`.contrib`, :mod:`.vision`, :mod:`.rcnn`), the INT8 ops
(:mod:`.quantization`), the graph ops (:mod:`.dgl`) and the user's
Python op ``Custom`` (:mod:`.custom_op`).
"""
from . import registry
from . import contrib
from . import control_flow
from . import custom_op
from . import dgl
from . import elemwise
from . import flash_attention
from . import image
from . import indexing
from . import init_ops
from . import linalg
from . import matrix
from . import nn
from . import optimizer_ops
from . import quantization
from . import random_ops
from . import rcnn
from . import reduce
from . import rnn_op
from . import vision

__all__ = ["registry", "contrib", "control_flow", "custom_op", "dgl",
           "elemwise", "flash_attention", "image", "indexing", "init_ops",
           "linalg", "matrix", "nn", "optimizer_ops", "quantization",
           "random_ops", "rcnn", "reduce", "rnn_op", "vision"]
