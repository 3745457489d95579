"""Devices of the PyTorch port.

Counterpart of ``mxtpu/context.py`` (``cpu()``, ``gpu()``,
``num_gpus()``, ``default_ctx``, ``current_context``).  A device is a
``torch.device``; ``gpu(i)`` is CUDA device ``i`` and the default is
``cuda:0``.  There is no ``tpu()``, and no ``with ctx:`` scope: a
``torch.device`` used as one would change torch's own default device.
NDArray's ``ctx`` is the ``torch.device`` of its tensor, so it compares
equal to ``cpu()`` or ``gpu(i)``.

Entry points take ``device=None`` and resolve it with :func:`resolve`:
the default runs on the card, and when no card is present the call
raises rather than carry on quietly on the CPU.  Pass ``device="cpu"``
to run on the CPU.
"""
from __future__ import annotations

import torch

from .base import MXNetError

__all__ = ["cpu", "gpu", "num_gpus", "default_ctx", "current_context",
           "resolve"]


def cpu(device_id: int = 0) -> torch.device:
    return torch.device("cpu")


def gpu(device_id: int = 0) -> torch.device:
    return torch.device("cuda", int(device_id))


def num_gpus() -> int:
    """The number of CUDA devices (0 without a card)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def default_ctx() -> torch.device:
    return gpu(0)


def current_context() -> torch.device:
    """The device an entry point runs on when the caller names none."""
    return default_ctx()


def resolve(device=None) -> torch.device:
    """The ``torch.device`` an entry point runs on: ``device`` (a
    ``torch.device`` or a string such as ``"cpu"``/``"cuda:0"``), or
    :func:`default_ctx` when None.  Raises when that is a CUDA device
    and no CUDA device is present."""
    dev = default_ctx() if device is None else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise MXNetError(
                "no CUDA device is present; pass device='cpu' to run on "
                "the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise MXNetError("unsupported device %r (the port runs on 'cuda' "
                         "or 'cpu')" % (str(dev),))
    return dev
