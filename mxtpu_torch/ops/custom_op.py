"""The ``Custom`` operator of the PyTorch port: a user's Python op in the
graph (counterpart of ``mxtpu/ops/custom_op.py``).

The user's ``CustomOp.forward``/``backward`` run inside a
``torch.autograd.Function``, so a custom op works the same in ``nd``,
under ``autograd.record()``, in an executor and in a hybridized block.
The op hands them NDArrays on its own device (the card's, or the CPU's),
as MXNet does, where the JAX package hands them host copies; the values
are the same.  One operator instance is made per call and shared by its
forward and backward; every request is ``"write"``; the backward is
given the head gradients whatever ``need_top_grad`` says (a loss head's
backward ignores them).  A CUDA graph cannot run Python, so
``FusedTrainLoop`` runs a graph holding a ``Custom`` node step by step
(``HOST_OPS``).

Shapes and dtypes come from the prop's ``infer_shape`` and
``infer_type`` (``forward_meta``): a user's op cannot run on ``meta``
tensors.  The prop registry lives here, so that the op exists before
the ``nd``/``sym`` functions are made; the user's classes are in
``mxtpu_torch/operator.py``.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..base import MXNetError, np_dtype, torch_dtype
from .registry import register

__all__ = ["PROP_REGISTRY", "HOST_OPS", "forward_meta"]

PROP_REGISTRY: Dict[str, type] = {}

# ops that run Python on the host at every call: no CUDA graph holds them
HOST_OPS = frozenset({"Custom"})


def _get_prop(attrs: Dict[str, Any]):
    op_type = attrs.get("op_type")
    if op_type is None:
        raise MXNetError("Custom requires op_type=")
    if op_type not in PROP_REGISTRY:
        raise MXNetError("custom op %r not registered" % op_type)
    kwargs = {k: v for k, v in attrs.items()
              if k not in ("op_type", "is_train")}
    return PROP_REGISTRY[op_type](**{k: str(v) for k, v in kwargs.items()})


def _custom_num_outputs(attrs) -> int:
    return len(_get_prop(attrs).list_outputs())


def _out_meta(prop, in_shapes, in_types):
    n_out = len(prop.list_outputs())
    _, out_shapes, _ = prop.infer_shape([tuple(s) for s in in_shapes])
    try:
        _, out_types, _ = prop.infer_type(list(in_types))
    except NotImplementedError:
        out_types = [in_types[0] if in_types else np.dtype(np.float32)] \
            * n_out
    return ([tuple(int(d) for d in s) for s in out_shapes],
            [np_dtype(t) for t in out_types])


def forward_meta(in_shapes, in_dtypes, attrs):
    """The output shapes and dtypes of a ``Custom`` node, from its prop."""
    return _out_meta(_get_prop(attrs), in_shapes,
                     [np.dtype(t) for t in in_dtypes])


class _Custom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, op, is_train, out_meta, *xs):
        from ..ndarray.ndarray import NDArray

        out_shapes, out_types = out_meta
        dev = xs[0].device if xs else torch.device("cpu")
        in_nd = [NDArray(x.detach()) for x in xs]
        out_nd = [NDArray(torch.zeros(s, dtype=torch_dtype(t), device=dev))
                  for s, t in zip(out_shapes, out_types)]
        op.forward(is_train=is_train, req=["write"] * len(out_nd),
                   in_data=in_nd, out_data=out_nd, aux=[])
        outs = tuple(o._data for o in out_nd)
        ctx.op = op
        ctx.save_for_backward(*xs, *outs)
        ctx.n_in = len(xs)
        ctx.mark_non_differentiable(*[o for o in outs
                                      if not o.is_floating_point()])
        return outs

    @staticmethod
    def backward(ctx, *grads):
        from ..ndarray.ndarray import NDArray

        saved = ctx.saved_tensors
        xs, outs = saved[:ctx.n_in], saved[ctx.n_in:]
        out_grad = [NDArray(g if g is not None else torch.zeros_like(o))
                    for g, o in zip(grads, outs)]
        in_grad = [NDArray(torch.zeros_like(x)) for x in xs]
        ctx.op.backward(req=["write"] * len(xs), out_grad=out_grad,
                        in_data=[NDArray(x) for x in xs],
                        out_data=[NDArray(o) for o in outs],
                        in_grad=in_grad, aux=[])
        return (None, None, None) + tuple(
            g._data if x.is_floating_point() else None
            for g, x in zip(in_grad, xs))


@register("Custom", num_outputs=_custom_num_outputs, train_aware=True)
def custom(*arrays, **attrs):
    """A registered ``CustomOpProp``'s operator (``op_type=``) on the
    arrays, in the order of its ``list_arguments``."""
    prop = _get_prop(attrs)
    is_train = bool(attrs.get("is_train", False))
    n_in = len(prop.list_arguments())
    if len(arrays) != n_in:
        raise MXNetError("Custom %r expects %d inputs, got %d"
                         % (attrs.get("op_type"), n_in, len(arrays)))
    in_shapes = [tuple(a.shape) for a in arrays]
    in_types = [np.dtype(np_dtype(a.dtype)) for a in arrays]
    meta = _out_meta(prop, in_shapes, in_types)
    op = prop.create_operator(arrays[0].device if arrays else None,
                              in_shapes, in_types)
    outs = _Custom.apply(op, is_train, meta, *arrays)
    return outs if len(outs) > 1 else outs[0]
