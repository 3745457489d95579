"""Base vocabulary of the PyTorch port: error types and env-var config.

Counterpart of ``mxtpu/base.py`` (``MXNetError``, ``MemoryExhaustedError``,
``RequestShedError``, ``getenv``/``getenv_int``), kept as a copy of its
own so that the port imports nothing of the JAX package.
"""
from __future__ import annotations

import os
from typing import Optional

__all__ = ["MXNetError", "MemoryExhaustedError", "RequestShedError",
           "getenv", "getenv_int"]


class MXNetError(RuntimeError):
    """Error raised by the framework (name kept for API parity with the
    reference's ``mxnet.base.MXNetError``)."""


class MemoryExhaustedError(MXNetError, MemoryError):
    """Device memory exhausted.  ``report`` carries whatever forensics
    the raiser had; it subclasses MemoryError so generic OOM handling
    still recognizes it."""

    def __init__(self, msg: str, report: Optional[dict] = None):
        super().__init__(msg)
        self.report = report or {}


class RequestShedError(MXNetError):
    """``mxtpu_torch.serve`` admission control rejected a request: the
    tenant's queue cap is full, the server is draining, or the request's
    deadline expired in the queue.  A deliberate overload response, not
    a fault: clients back off.  ``reason`` is one of ``"queue_full"``,
    ``"draining"``, ``"timeout"``, ``"overload"``."""

    def __init__(self, msg: str, reason: str = "overload"):
        super().__init__(msg)
        self.reason = reason


def getenv(name: str, default: Optional[str] = None) -> Optional[str]:
    """Read an env var; ``MXNET_X`` is also read as ``MXTPU_X`` (which
    wins), as the JAX package does."""
    if name.startswith("MXNET_"):
        alt = "MXTPU_" + name[len("MXNET_"):]
        if alt in os.environ:
            return os.environ[alt]
    return os.environ.get(name, default)


def getenv_int(name: str, default: int) -> int:
    val = getenv(name)
    if val is None or val == "":
        return default
    return int(val)
