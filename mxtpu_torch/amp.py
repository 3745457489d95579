"""Automatic mixed precision of the PyTorch port: the compute-dtype policy.

Counterpart of ``mxtpu/amp.py``, with its op lists.  Parameters stay
float32 (the master weights); the executor's graph walk
(``executor._build_graph_fn``) casts each node's inputs by this policy:

* the ops of ``LOWP_OPS`` (products, convolutions, pooling...) take
  their float32 inputs in the compute dtype (bfloat16 reaches the
  tensor cores);
* the ops of ``FP32_OPS`` (softmax, losses, norms...) take their
  compute-dtype inputs in float32;
* every other op runs in whatever dtype arrives, and torch's promotion
  widens mixed inputs, as the JAX package's does; so BatchNorm, the
  activations and the residual adds receive bfloat16.

The casts are ops of the graph, so the gradients reach the float32
parameters in float32 through the casts' backward, and the optimizer
needs no multi-precision.  This is the reference's policy node by node,
not ``torch.autocast``, whose op lists are torch's own (it would run
BatchNorm and the residual adds in float32).

Usage::

    mxtpu_torch.amp.set_compute_dtype("bfloat16")   # before bind
    ... bind / fit ...
    mxtpu_torch.amp.set_compute_dtype(None)         # back to float32

or ``with amp.scope("bfloat16"):`` around the bind.  An executor keeps
the policy that was set when it was bound.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Optional

import torch

from .base import torch_dtype

__all__ = ["set_compute_dtype", "get_compute_dtype", "scope",
           "cast_op_inputs", "LOWP_OPS", "FP32_OPS"]

_state = threading.local()

# the reference's FP16_FUNCS: run in the low-precision compute dtype
LOWP_OPS = {
    "Convolution", "Deconvolution", "FullyConnected", "dot", "batch_dot",
    "RNN", "Correlation", "_linalg_gemm", "_linalg_gemm2",
    # bandwidth-bound stages: bf16 halves their memory traffic
    "Pooling", "Pooling_v1", "_contrib_AdaptiveAvgPooling2D",
    "UpSampling", "_contrib_BilinearResize2D", "BilinearSampler",
    "Embedding", "Concat", "add_n",
}

# the reference's FP32_FUNCS: numerically sensitive, float32 inputs
FP32_OPS = {
    "SoftmaxOutput", "softmax", "log_softmax", "SoftmaxActivation",
    "LayerNorm", "InstanceNorm", "L2Normalization", "LRN",
    "CTCLoss", "_contrib_CTCLoss", "MakeLoss", "SVMOutput",
    "LinearRegressionOutput", "LogisticRegressionOutput",
    "MAERegressionOutput", "norm", "exp", "log", "log2", "log10",
    "expm1", "log1p", "pow", "_power", "_power_scalar", "erfinv",
    "SpatialTransformer", "GridGenerator",
}

# inputs never narrowed inside a LOWP op: bf16 rounds float-typed index
# tensors above 256 to the wrong integer
_LOWP_SKIP_INPUTS = {"Embedding": {0}}


def set_compute_dtype(dtype: Optional[str]) -> None:
    """Set (or clear, with None) the compute dtype of executors bound
    after this call, on this thread."""
    _state.dtype = dtype


def get_compute_dtype() -> Optional[str]:
    return getattr(_state, "dtype", None)


@contextmanager
def scope(dtype: Optional[str]):
    prev = get_compute_dtype()
    set_compute_dtype(dtype)
    try:
        yield
    finally:
        set_compute_dtype(prev)


def cast_op_inputs(op_name: str, invals, dtype):
    """One node's inputs under the policy for compute dtype ``dtype``:
    only float32 (LOWP) or compute-dtype (FP32) tensors are cast; every
    other input passes through."""
    dt = torch_dtype(dtype)
    f32 = torch.float32
    if op_name in LOWP_OPS:
        skip = _LOWP_SKIP_INPUTS.get(op_name, ())
        return [v.to(dt) if i not in skip and v.dtype == f32 else v
                for i, v in enumerate(invals)]
    if op_name in FP32_OPS:
        return [v.to(f32) if v.dtype == dt else v for v in invals]
    return invals
