"""Base vocabulary of the PyTorch port: error types, dtypes, env-var
config and small helpers.

Counterpart of ``mxtpu/base.py`` (``MXNetError``, ``MemoryExhaustedError``,
``RequestShedError``, the parameter server's ``KVStoreTimeoutError``,
``PSConnectError`` and ``ServerDiedError``, ``_Null``, ``np_dtype``,
``shape2tuple``, ``getenv``/``getenv_int``), kept as a copy of its own
so that the port imports nothing of the JAX package.  It adds the map
between numpy's dtypes, which the API speaks, and torch's, which the
tensors carry (``torch_dtype``, ``dtype_of_torch``).
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["MXNetError", "MemoryExhaustedError", "RequestShedError",
           "KVStoreTimeoutError", "PSConnectError", "ServerDiedError",
           "integer_types", "mx_real_t",
           "_Null", "np_dtype", "torch_dtype", "dtype_of_torch",
           "shape2tuple", "getenv", "getenv_int"]


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


class KVStoreTimeoutError(MXNetError, TimeoutError):
    """A kvstore push/pull got no server response within
    MXTPU_KVSTORE_TIMEOUT.  Subclasses TimeoutError so the retry layer
    treats it as transient."""


class PSConnectError(MXNetError, ConnectionError):
    """The parameter server's transport could not reach a peer within
    its backoff and deadline budget (``_ps._Client._connect``)."""


class ServerDiedError(MXNetError):
    """A parameter server is dead and no replica can take over.  Not an
    OSError, so the retry layer propagates it at once."""


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


integer_types = (int, np.integer)

mx_real_t = np.float32


class _NullType(object):
    """Placeholder for missing attribute values (the op codegen drops
    attrs that hold it)."""

    _inst = None

    def __new__(cls):
        if cls._inst is None:
            cls._inst = super().__new__(cls)
        return cls._inst

    def __repr__(self):
        return "_Null"

    def __bool__(self):
        return False


_Null = _NullType()

try:  # numpy has no bfloat16 of its own; ml_dtypes gives it one
    import ml_dtypes as _ml_dtypes

    _BFLOAT16 = np.dtype(_ml_dtypes.bfloat16)
except ImportError:  # pragma: no cover
    _BFLOAT16 = None

_TORCH_OF_NP = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.bool_): torch.bool,
}
_NP_OF_TORCH = {v: k for k, v in _TORCH_OF_NP.items()}


def np_dtype(dtype) -> np.dtype:
    """Normalize a user-provided dtype (str/np.dtype/type/'bfloat16');
    None is float32.  bfloat16 needs the ml_dtypes package."""
    if dtype is None:
        return np.dtype(mx_real_t)
    if isinstance(dtype, torch.dtype):
        return dtype_of_torch(dtype)
    if isinstance(dtype, str) and dtype == "bfloat16":
        if _BFLOAT16 is None:
            raise MXNetError("bfloat16 as a numpy dtype needs ml_dtypes")
        return _BFLOAT16
    return np.dtype(dtype)


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a user-provided dtype (None is float32)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype is None:
        return torch.float32
    if str(dtype) == "bfloat16" or (_BFLOAT16 is not None
                                    and np.dtype(dtype) == _BFLOAT16):
        return torch.bfloat16
    try:
        return _TORCH_OF_NP[np.dtype(dtype)]
    except KeyError:
        raise MXNetError("unsupported dtype %r" % (dtype,)) from None


def dtype_of_torch(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype of a torch dtype."""
    if dtype == torch.bfloat16:
        return np_dtype("bfloat16")
    try:
        return _NP_OF_TORCH[dtype]
    except KeyError:
        raise MXNetError("unsupported dtype %r" % (dtype,)) from None


def shape2tuple(shape) -> Tuple[int, ...]:
    if isinstance(shape, integer_types):
        return (int(shape),)
    return tuple(int(s) for s in shape)
