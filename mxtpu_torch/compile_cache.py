"""Shape buckets of the PyTorch port.

Counterpart of the "Shape buckets" part of ``mxtpu/compile_cache.py``
(``get_bucket_policy``, ``_parse_policy``, ``bucket_batch``,
``bucket_set``), with the same ``MXTPU_SHAPE_BUCKETS`` grammar:
``pow2`` (pad the leading batch dim up to the next power of two),
``mult:N`` (round up to a multiple of N), ``fixed:a,b,c`` (the smallest
listed size that fits; larger batches run exact), ``1`` for ``pow2``,
and ``0``/``off`` for no bucketing.  The XLA persistent cache of that
module has no counterpart: PyTorch runs eagerly and compiles nothing
per shape.
"""
from __future__ import annotations

import functools
from typing import List, Optional

from .base import MXNetError, getenv

__all__ = ["get_bucket_policy", "bucket_batch", "bucket_set"]


def get_bucket_policy() -> Optional[str]:
    """The bucket policy from ``MXTPU_SHAPE_BUCKETS``, or None when
    bucketing is off."""
    spec = getenv("MXTPU_SHAPE_BUCKETS")
    if spec in (None, "", "0", "off", "false", "False", "none"):
        return None
    return "pow2" if spec in ("1", "true", "True") else spec


@functools.lru_cache(maxsize=64)
def _parse_policy(spec: str):
    if spec == "pow2":
        return ("pow2",)
    if spec.startswith("mult:"):
        n = int(spec[5:])
        if n < 1:
            raise MXNetError("mult bucket step must be >= 1, got %d" % n)
        return ("mult", n)
    if spec.startswith("fixed:"):
        sizes = sorted(int(s) for s in spec[6:].split(",") if s)
        if not sizes:
            raise MXNetError("fixed bucket policy needs at least one size")
        return ("fixed", sizes)
    raise MXNetError(
        "bucket policy must be 'pow2', 'mult:N' or 'fixed:a,b,...' "
        "(got %r)" % (spec,))


def bucket_batch(n: int, spec: Optional[str] = None) -> int:
    """The padded leading dim for a ragged batch of ``n`` under the
    active (or given) policy.  Always >= n; returns n when bucketing is
    off or no bucket fits."""
    if spec is None:
        spec = get_bucket_policy()
    if spec is None or n < 1:
        return n
    policy = _parse_policy(spec)
    if policy[0] == "pow2":
        b = 1
        while b < n:
            b <<= 1
        return b
    if policy[0] == "mult":
        step = policy[1]
        return ((n + step - 1) // step) * step
    for size in policy[1]:
        if size >= n:
            return size
    return n


def bucket_set(cap: int, spec: Optional[str] = None) -> List[int]:
    """Every bucket size the policy produces for batches of 1..cap,
    ascending: under ``pow2`` and cap 32, [1, 2, 4, 8, 16, 32]."""
    if spec is None:
        spec = get_bucket_policy() or "pow2"
    cap = max(1, int(cap))
    sizes = sorted({bucket_batch(n, spec) for n in range(1, cap + 1)})
    return [s for s in sizes if s <= cap] or [cap]
