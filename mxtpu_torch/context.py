"""Devices of the PyTorch port.

Counterpart of ``mxtpu/context.py``: ``Context`` with ``cpu()``,
``gpu()``, ``cpu_pinned()``, ``cpu_shared()``, ``num_gpus()``,
``default_ctx``, ``current_context`` and ``device_of``.  ``gpu(i)`` is
CUDA device ``i``; there is no ``tpu()``.

A ``Context`` is the port's own class (``torch.device`` cannot be
subclassed), converted to a ``torch.device`` wherever it meets torch:
``ctx.torch_device`` or :func:`resolve`.  A ``cpu``/``gpu`` context
compares equal to the ``torch.device`` it names, and hashes as that
device does, so ``arr.ctx == torch.device("cpu")`` holds and a function
patched to return a ``torch.device`` where a ``Context`` was returned
keeps working.  ``cpu_pinned`` and ``cpu_shared`` name the host too
(their ``torch_device`` is the CPU), but an array made on them is
page-locked (``pin_memory()``, which needs CUDA: without it the
creation raises) or in shared memory (``share_memory_()``), and its
``ctx`` says so.

``with ctx:`` makes ``ctx`` the default of the calling thread until the
block ends; scopes nest, and each thread has its own.  With no scope the
default is ``MXNET_DEFAULT_CONTEXT`` (``gpu:0``, ``cpu``...) when it is
set, else ``gpu(0)``: entry points given no context run on the card,
and when no card is present they raise rather than carry on quietly on
the CPU.  ``with mx.cpu():`` (or ``ctx=mx.cpu()``) asks for the CPU.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError, getenv

__all__ = ["Context", "cpu", "gpu", "cpu_pinned", "cpu_shared",
           "num_gpus", "default_ctx", "current_context", "device_of",
           "resolve", "torch_device", "as_context", "place"]


class Context(object):
    """A device: its type (``cpu``, ``gpu``, ``cpu_pinned``,
    ``cpu_shared``) and number.  Usable as a ``with`` scope."""

    devtype2str = {1: "cpu", 2: "gpu", 3: "cpu_pinned", 5: "cpu_shared"}
    devstr2type = {"cpu": 1, "gpu": 2, "cpu_pinned": 3, "cpu_shared": 5}

    _default_ctx = threading.local()

    def __init__(self, device_type, device_id: int = 0):
        if isinstance(device_type, Context):
            self.device_typeid = device_type.device_typeid
            self.device_id = device_type.device_id
            return
        if isinstance(device_type, torch.device):
            if device_type.type not in ("cpu", "cuda"):
                raise MXNetError("no context for device %r" % (
                    str(device_type),))
            self.device_typeid = 2 if device_type.type == "cuda" else 1
            self.device_id = device_type.index or 0
            return
        if device_type not in self.devstr2type:
            raise MXNetError("unknown device type %r" % (device_type,))
        self.device_typeid = self.devstr2type[device_type]
        self.device_id = int(device_id)

    @property
    def device_type(self) -> str:
        return self.devtype2str[self.device_typeid]

    @property
    def torch_device(self) -> torch.device:
        """The ``torch.device`` of this context (the CPU for the host
        kinds)."""
        if self.device_typeid == 2:
            return torch.device("cuda", self.device_id)
        return torch.device("cpu")

    def __hash__(self):
        if self.device_typeid in (1, 2):
            return hash(self.torch_device)
        return hash((self.device_typeid, self.device_id))

    def __eq__(self, other):
        if isinstance(other, Context):
            return self.device_typeid == other.device_typeid \
                and self.device_id == other.device_id
        if isinstance(other, torch.device):
            return self.device_typeid in (1, 2) \
                and self.torch_device == other
        return NotImplemented

    def __str__(self):
        return "%s(%d)" % (self.device_type, self.device_id)

    __repr__ = __str__

    def __enter__(self):
        stack = getattr(self._default_ctx, "stack", None)
        if stack is None:
            stack = self._default_ctx.stack = []
        stack.append(self)
        return self

    def __exit__(self, *args):
        self._default_ctx.stack.pop()

    def empty_cache(self):
        """Hand the caching allocator's unused blocks back to the card
        (nothing to do for the host kinds)."""
        if self.device_typeid == 2 and torch.cuda.is_available():
            with torch.cuda.device(self.device_id):
                torch.cuda.empty_cache()


def cpu(device_id: int = 0) -> Context:
    return Context("cpu", device_id)


def gpu(device_id: int = 0) -> Context:
    return Context("gpu", device_id)


def cpu_pinned(device_id: int = 0) -> Context:
    return Context("cpu_pinned", device_id)


def cpu_shared(device_id: int = 0) -> Context:
    return Context("cpu_shared", device_id)


def num_gpus() -> int:
    """The number of CUDA devices (0 without a card)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def default_ctx() -> Context:
    """The innermost ``with ctx:`` of this thread, else
    ``MXNET_DEFAULT_CONTEXT``, else ``gpu(0)``."""
    stack = getattr(Context._default_ctx, "stack", None)
    if stack:
        return stack[-1]
    dev = getenv("MXNET_DEFAULT_CONTEXT")
    if dev:
        name, _, idx = dev.partition(":")
        return Context(name, int(idx or 0))
    return gpu(0)


def current_context() -> Context:
    """The context an entry point runs on when the caller names none."""
    return default_ctx()


def device_of(array) -> Context:
    """The context of an NDArray."""
    return array.ctx


def torch_device(device) -> torch.device:
    """The ``torch.device`` of a ``Context``, a ``torch.device`` or a
    string (``"cpu"``, ``"cuda:0"``, or a context's name such as
    ``"gpu"``), with no check that it is present."""
    if isinstance(device, Context):
        return device.torch_device
    if isinstance(device, str) and device in Context.devstr2type:
        return Context(device).torch_device
    return torch.device(device)


def as_context(device) -> Context:
    """``device`` (a ``Context``, a ``torch.device`` or a string) as a
    ``Context``, with no check that it is present."""
    if isinstance(device, Context):
        return device
    return Context(torch_device(device))


def resolve(device=None) -> torch.device:
    """The ``torch.device`` an entry point runs on: ``device`` (a
    ``Context``, a ``torch.device`` or a string), or :func:`default_ctx`
    when None.  Raises when that is a CUDA device and no CUDA device is
    present."""
    dev = torch_device(default_ctx() if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise MXNetError(
                "no CUDA device is present; pass ctx=mx.cpu() (or use "
                "`with mx.cpu():`) to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise MXNetError("unsupported device %r (the port runs on 'cuda' "
                         "or 'cpu')" % (str(dev),))
    return dev


def place(tensor: torch.Tensor, ctx) -> torch.Tensor:
    """``tensor`` (on the host) as a ``cpu_pinned`` or ``cpu_shared``
    context keeps it: page-locked, or moved to shared memory; any other
    context leaves it as it is."""
    if not isinstance(ctx, Context):
        return tensor
    if ctx.device_typeid == 3:
        if not torch.cuda.is_available():
            raise MXNetError("cpu_pinned needs CUDA: host memory is "
                             "page-locked for the card's copies")
        return tensor.pin_memory()
    if ctx.device_typeid == 5:
        return tensor.share_memory_()
    return tensor
