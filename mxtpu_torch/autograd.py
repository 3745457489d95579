"""Imperative differentiation of the PyTorch port.

Counterpart of the part of ``mxtpu/autograd.py`` that NDArray and the
tests use: the scopes (``record``/``pause``/``train_mode``/
``predict_mode``, ``is_recording``/``is_training``), ``mark_variables``
and ``backward``.  torch's autograd is the tape: an op runs with grad
enabled only under ``record()``, and a marked variable is a leaf tensor
that requires grad.  ``backward`` asks torch for the gradients of the
heads with respect to the marked leaves it reaches and writes them into
their ``.grad`` arrays by their ``grad_req`` (``write`` or ``add``).
``grad(create_graph=True)`` and the custom ``Function`` are not ported.
"""
from __future__ import annotations

import threading
import weakref
from typing import List, Optional

import torch

from .base import MXNetError

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training",
           "mark_variables", "backward"]


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
            if g is None:
                g = torch.zeros_like(var._data)
            if var._grad_req == "add":
                var._grad._data.add_(g)
            elif var._grad_req == "write":
                var._grad._data.copy_(g)
