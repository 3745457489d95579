"""Retries of the PyTorch port (counterpart of part of
``mxtpu/resilience.py``): :func:`run_with_retry` and :func:`guarded`
retry a call that fails with a transient error (an ``OSError``: a
refused or reset socket, a ``KVStoreTimeoutError``) with exponential
backoff, full jitter and a wall-clock deadline, and raise
:class:`RetryExhausted` when the budget is spent.  The parameter
server's connects and the distributed store's pushes and pulls run
under them.

Knobs, as in the JAX package: ``MXTPU_RETRY_MAX`` (retries after the
first attempt, default 5), ``MXTPU_RETRY_TIMEOUT`` (deadline in
seconds, default 60; <= 0 disables it), ``MXTPU_RETRY_BASE`` (first
backoff, default 0.05 s).

Fault injection, atomic checkpoint files, the preemption hook and the
bad-step guard are not ported (ROADMAP A17); no setting arms a fault.
"""
from __future__ import annotations

import random as _random
import time
from typing import Any, Callable, Optional, Tuple

from .base import MXNetError, MemoryExhaustedError, getenv, getenv_int

__all__ = ["RetryExhausted", "TRANSIENT_ERRORS", "PERMANENT_ERRORS",
           "run_with_retry", "guarded"]


class RetryExhausted(MXNetError):
    """A retried call kept failing past MXTPU_RETRY_MAX /
    MXTPU_RETRY_TIMEOUT; ``__cause__`` is the last underlying error."""


#: Errors a retry treats as transient.
TRANSIENT_ERRORS: Tuple[type, ...] = (OSError,)

#: Errors no retry fixes: they propagate at once, unwrapped.
PERMANENT_ERRORS: Tuple[type, ...] = (FileNotFoundError, IsADirectoryError,
                                      NotADirectoryError, PermissionError,
                                      MemoryExhaustedError)

_BACKOFF_CAP = 2.0
_retry_rng = _random.Random(0x5EED)


def _retry_max() -> int:
    return max(0, getenv_int("MXTPU_RETRY_MAX", 5))


def _retry_timeout() -> float:
    val = getenv("MXTPU_RETRY_TIMEOUT")
    return 60.0 if val in (None, "") else float(val)


def _retry_base() -> float:
    val = getenv("MXTPU_RETRY_BASE")
    return 0.05 if val in (None, "") else float(val)


def run_with_retry(site: str, fn: Callable[[], Any],
                   retry_on: Tuple[type, ...] = TRANSIENT_ERRORS,
                   max_retries: Optional[int] = None,
                   deadline: Optional[float] = None) -> Any:
    """``fn()``, retried on ``retry_on`` errors with exponential backoff
    and full jitter, at most ``max_retries`` times (MXTPU_RETRY_MAX)
    and within ``deadline`` seconds (MXTPU_RETRY_TIMEOUT; <= 0: none).
    Raises :class:`RetryExhausted` (cause: the last error) when the
    budget runs out; other errors propagate at once."""
    retries = _retry_max() if max_retries is None else max_retries
    budget = _retry_timeout() if deadline is None else deadline
    base = _retry_base()
    t0 = time.monotonic()
    attempt = 0
    while True:
        try:
            return fn()
        except retry_on as e:
            if isinstance(e, PERMANENT_ERRORS):
                raise
            elapsed = time.monotonic() - t0
            if attempt >= retries or (budget > 0 and elapsed >= budget):
                raise RetryExhausted(
                    "%r failed %d time(s) over %.2fs (MXTPU_RETRY_MAX=%d,"
                    " MXTPU_RETRY_TIMEOUT=%.1f): %s"
                    % (site, attempt + 1, elapsed, retries, budget,
                       e)) from e
            sleep = min(_BACKOFF_CAP, base * (2 ** attempt))
            sleep *= 0.5 + 0.5 * _retry_rng.random()
            if budget > 0:
                sleep = min(sleep, max(0.0, budget - elapsed))
            if sleep > 0:
                time.sleep(sleep)
            attempt += 1


def guarded(site: str, fn: Callable, *args,
            _retry_deadline: Optional[float] = None, **kwargs) -> Any:
    """``fn(*args, **kwargs)`` under :func:`run_with_retry`;
    ``_retry_deadline`` replaces the MXTPU_RETRY_TIMEOUT budget where
    one attempt may rightly take longer (a distributed push or pull,
    bounded by MXTPU_KVSTORE_TIMEOUT)."""
    return run_with_retry(site, lambda: fn(*args, **kwargs),
                          deadline=_retry_deadline)
