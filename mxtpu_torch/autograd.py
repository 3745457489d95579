"""Imperative differentiation of the PyTorch port.

Counterpart of the part of ``mxtpu/autograd.py`` that NDArray and the
tests use: the scopes (``record``/``pause``/``train_mode``/
``predict_mode``, ``is_recording``/``is_training``), ``mark_variables``
and ``backward``.  torch's autograd is the tape: an op runs with grad
enabled only under ``record()``, and a marked variable is a leaf tensor
that requires grad.  ``backward`` asks torch for the gradients of the
heads with respect to the marked leaves it reaches and writes them into
their ``.grad`` arrays by their ``grad_req`` (``write`` or ``add``).

Row-sparse gradients (the JAX package's ``SparseCot``): a sparse
lookup or product (``Embedding(sparse_grad=True)``, ``sparse.dot``)
hands a leaf weight a sparse COO gradient, which the engine sums with
the leaf's other contributions.  A leaf whose ``.grad`` is a
``RowSparseNDArray`` (``attach_grad(stype="row_sparse")``) takes it
coalesced (rows sorted and unique, duplicates summed), or, when a dense
path reached the leaf too, the rows of the dense sum that hold a
non-zero (``cast_storage``); ``grad_req="add"`` raises for it, as in
the reference.  A dense ``.grad`` takes the densified gradient.

``grad`` returns the gradients of heads with respect to variables
(marked, or results recorded under ``record()``) without touching
their ``.grad``; with ``create_graph`` the gradient is itself a
recorded result (torch's graph of the derivative), which a later
``backward`` or ``grad`` differentiates again.  ``Function`` is the
custom differentiable function: ``forward`` and ``backward`` over
NDArrays, run under ``pause()``, bridged to a
``torch.autograd.Function``.  ``get_symbol`` raises, as the JAX
package's does: a recorded computation becomes a graph through
``hybridize()``.
"""
from __future__ import annotations

import threading
import weakref
from typing import List, Optional

import torch

from .base import MXNetError

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training",
           "mark_variables", "backward", "grad", "get_symbol", "Function"]


class _AGState(threading.local):
    def __init__(self):
        self.recording = False
        self.training = False


_STATE = _AGState()


def is_recording() -> bool:
    return _STATE.recording


def is_training() -> bool:
    return _STATE.training


def set_recording(flag: bool) -> bool:
    prev, _STATE.recording = _STATE.recording, bool(flag)
    return prev


def set_training(flag: bool) -> bool:
    prev, _STATE.training = _STATE.training, bool(flag)
    return prev


class _RecordingScope(object):
    """Scope flipping the recording/training flags."""

    def __init__(self, recording: Optional[bool], training: Optional[bool]):
        self._rec = recording
        self._train = training
        self._prev_rec = None
        self._prev_train = None

    def __enter__(self):
        if self._rec is not None:
            self._prev_rec = set_recording(self._rec)
        if self._train is not None:
            self._prev_train = set_training(self._train)
        return self

    def __exit__(self, *args):
        if self._rec is not None:
            set_recording(self._prev_rec)
        if self._train is not None:
            set_training(self._prev_train)


def record(train_mode: bool = True):
    return _RecordingScope(True, train_mode)


def pause(train_mode: bool = False):
    return _RecordingScope(False, train_mode)


def train_mode():
    return _RecordingScope(None, True)


def predict_mode():
    return _RecordingScope(None, False)


def mark_variables(variables, gradients, grad_reqs="write"):
    """Attach gradient buffers to variables (reference
    ``autograd.mark_variables``): each becomes a leaf that requires
    grad, found again by ``backward`` through its tensor."""
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for var, gradbuf, req in zip(variables, gradients, grad_reqs):
        var._data = var._data.detach().requires_grad_(req != "null")
        var._data._mx_owner = weakref.ref(var)
        var._grad = gradbuf
        var._grad_req = req


def _owner(t):
    ref = getattr(t, "_mx_owner", None)
    return ref() if ref is not None else None


def _marked_leaves(tensors) -> List:
    """The marked NDArrays whose tensors the heads' graph reaches."""
    found, seen = {}, set()
    stack = []
    for t in tensors:
        if t.grad_fn is not None:
            stack.append(t.grad_fn)
        elif _owner(t) is not None:
            found[id(t)] = _owner(t)
    while stack:
        fn = stack.pop()
        if fn in seen:
            continue
        seen.add(fn)
        for nxt, _ in fn.next_functions:
            if nxt is None:
                continue
            var = getattr(nxt, "variable", None)
            if var is not None:
                nd = _owner(var)
                if nd is not None and nd._data is var:
                    found[id(var)] = nd
            else:
                stack.append(nxt)
    return list(found.values())


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Gradients of ``heads`` with respect to the marked variables,
    written into their ``.grad`` arrays (reference
    ``autograd.backward``).  A head gradient of None is ones."""
    if not isinstance(heads, (list, tuple)):
        heads = [heads]
    if head_grads is None:
        head_grads = [None] * len(heads)
    elif not isinstance(head_grads, (list, tuple)):
        head_grads = [head_grads]
    tensors = [h._data for h in heads]
    if not any(t.requires_grad for t in tensors):
        raise MXNetError("cannot differentiate: the heads were not "
                         "computed under autograd.record() from a marked "
                         "variable")
    seeds = [torch.ones_like(t) if g is None else g._data
             for t, g in zip(tensors, head_grads)]
    leaves = _marked_leaves(tensors)
    grads = torch.autograd.grad(tensors, [v._data for v in leaves], seeds,
                                retain_graph=retain_graph, allow_unused=True)
    with torch.no_grad():
        for var, g in zip(leaves, grads):
            if var._grad is None:
                continue
            if var._grad.stype == "row_sparse":
                _write_row_sparse(var, g)
                continue
            if g is None:
                g = torch.zeros_like(var._data)
            elif g.is_sparse:
                g = g.to_dense()
            if var._grad_req == "add":
                var._grad._data.add_(g)
            elif var._grad_req == "write":
                var._grad._data.copy_(g)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """The gradients of ``heads`` with respect to ``variables``, as a
    list of NDArrays (reference ``autograd.grad``); ``.grad`` is left
    as it is.  A variable the heads do not reach gets zeros.  The graph
    is kept when ``retain_graph`` (by default when ``create_graph``)."""
    from .ndarray.ndarray import NDArray

    if isinstance(heads, NDArray):
        heads = [heads]
    if isinstance(variables, NDArray):
        variables = [variables]
    if head_grads is None:
        head_grads = [None] * len(heads)
    elif isinstance(head_grads, NDArray):
        head_grads = [head_grads]
    if len(heads) != len(head_grads):
        raise MXNetError("heads and head_grads length mismatch")
    for v in variables:
        if not v._data.requires_grad:
            raise MXNetError("one of the variables was not used in the "
                             "graph or not marked with attach_grad/"
                             "mark_variables")
    tensors = [h._data for h in heads]
    seeds = [torch.ones_like(t) if g is None else g._data
             for t, g in zip(tensors, head_grads)]
    grads = torch.autograd.grad(
        tensors, [v._data for v in variables], seeds,
        retain_graph=create_graph if retain_graph is None else retain_graph,
        create_graph=create_graph, allow_unused=True)
    out = []
    for v, g in zip(variables, grads):
        if g is None:
            g = torch.zeros_like(v._data)
        elif g.is_sparse:
            g = g.to_dense()
        out.append(NDArray(g if create_graph else g.detach()))
    return out


class _FunctionBridge(torch.autograd.Function):
    """Runs a :class:`Function`'s ``forward`` and ``backward`` on the
    tensors torch's engine hands over."""

    @staticmethod
    def forward(ctx, func, *tensors):
        from .ndarray.ndarray import NDArray

        ctx.func, ctx.n_in = func, len(tensors)
        with pause():
            outs = func.forward(*[NDArray(t) for t in tensors])
        func._single = not isinstance(outs, (list, tuple))
        outs = [outs] if func._single else list(outs)
        if not all(isinstance(o, NDArray) for o in outs):
            raise MXNetError("Function.forward must return NDArrays")
        return tuple(o._data for o in outs)

    @staticmethod
    def backward(ctx, *out_grads):
        from .ndarray.ndarray import NDArray

        with pause():
            igrads = ctx.func.backward(*[NDArray(g) for g in out_grads])
        if not isinstance(igrads, (list, tuple)):
            igrads = [igrads]
        if len(igrads) != ctx.n_in:
            raise MXNetError("Function.backward returned %d grads for %d "
                             "inputs" % (len(igrads), ctx.n_in))
        return (None,) + tuple(g._data if isinstance(g, NDArray) else g
                               for g in igrads)


def get_symbol(x):
    raise MXNetError("autograd.get_symbol is not supported; use hybridize()")


class Function(object):
    """Custom differentiable function (reference ``autograd.Function``):
    subclass with ``forward(*inputs)`` and ``backward(*output_grads)``,
    both over NDArrays; called under ``record()``, its outputs are
    recorded and their gradient runs ``backward``.

        class Sigmoid(autograd.Function):
            def forward(self, x):
                y = 1 / (1 + (-x).exp())
                self.save_for_backward(y)
                return y
            def backward(self, dy):
                (y,) = self.saved_tensors
                return dy * y * (1 - y)
    """

    def __init__(self):
        self.saved_tensors = ()
        self._single = True

    def save_for_backward(self, *tensors):
        self.saved_tensors = tensors

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray.ndarray import NDArray

        if not is_recording():
            with pause():
                return self.forward(*inputs)
        with torch.enable_grad():
            outs = _FunctionBridge.apply(self, *[x._data for x in inputs])
        outs = [NDArray(o) for o in outs]
        return outs[0] if self._single else outs


def _write_row_sparse(var, g):
    """Write the gradient ``g`` (sparse COO, dense or None) into the
    ``RowSparseNDArray`` ``var._grad``."""
    from .ndarray.ndarray import NDArray
    from .ndarray.sparse import RowSparseNDArray, cast_storage, zeros

    if var._grad_req == "add":
        raise MXNetError("grad_req='add' is not supported for row_sparse "
                         "gradients (reference parity)")
    dtype = var._grad._data.dtype
    if g is None:
        rsp = zeros("row_sparse", var.shape, ctx=var.ctx, dtype=dtype)
    elif g.is_sparse:
        g = g.coalesce()
        rsp = RowSparseNDArray(g.values().to(dtype), (g.indices()[0],),
                               var.shape)
    else:
        rsp = cast_storage(NDArray(g.to(dtype)), "row_sparse")
    var._grad._assign(rsp)
