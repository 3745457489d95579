"""Streaming percentile histograms of the PyTorch port.

Counterpart of ``mxtpu/telemetry.py``'s ``Histogram`` and
``histogram()``: only what ``serve`` needs for its request-latency
p50/p95/p99.  The event ring, metrics providers and cross-process
aggregation of that module are not ported yet (ROADMAP A18).
"""
from __future__ import annotations

import math
import threading
from typing import Any, Dict

__all__ = ["Histogram", "histogram"]


class Histogram(object):
    """Bounded streaming percentile histogram over log-spaced buckets.

    Fixed memory, O(1) :meth:`record`, thread-safe.  Buckets grow
    geometrically by ``10**(1/bins_per_decade)`` from ``low`` to
    ``high`` (values outside clamp into the under/overflow buckets), so
    a quantile is answered within about ``(growth-1)/2`` relative error:
    +-7% at the default 16 bins per decade."""

    def __init__(self, low: float = 1e-6, high: float = 1e4,
                 bins_per_decade: int = 16):
        if not (0 < low < high):
            raise ValueError("need 0 < low < high, got %r, %r"
                             % (low, high))
        self.low = float(low)
        self.high = float(high)
        self._log_growth = math.log(10.0) / max(1, int(bins_per_decade))
        # bucket 0 = underflow (<= low); last = overflow (>= high)
        self.nbins = int(math.ceil(
            math.log(high / low) / self._log_growth)) + 2
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self._counts = [0] * self.nbins
            self.count = 0
            self.total = 0.0
            self.vmin = float("inf")
            self.vmax = float("-inf")

    def _index(self, v: float) -> int:
        if v <= self.low:
            return 0
        if math.isinf(v):
            return self.nbins - 1
        i = int(math.log(v / self.low) / self._log_growth) + 1
        return min(i, self.nbins - 1)

    def record(self, value: float) -> None:
        v = float(value)
        if v != v:  # NaN lands nowhere sane
            return
        i = self._index(v)
        v = min(max(v, self.low), self.high) if math.isinf(v) else v
        with self._lock:
            self._counts[i] += 1
            self.count += 1
            self.total += v
            self.vmin = min(self.vmin, v)
            self.vmax = max(self.vmax, v)

    def quantile(self, q: float) -> float:
        """The q-quantile (0..1) as the geometric midpoint of the bucket
        holding that rank, clamped to the observed [min, max].  0.0 when
        empty."""
        with self._lock:
            counts = list(self._counts)
            n, vmin, vmax = self.count, self.vmin, self.vmax
        if n <= 0:
            return 0.0
        rank = min(n - 1, max(0, int(math.ceil(q * n)) - 1))
        acc = 0
        idx = self.nbins - 1
        for i, c in enumerate(counts):
            acc += c
            if acc > rank:
                idx = i
                break
        est = self.low if idx == 0 else \
            self.low * math.exp(self._log_growth * (idx - 0.5))
        return min(max(est, vmin), vmax)

    def percentiles(self) -> Dict[str, float]:
        return {"p50": self.quantile(0.50), "p95": self.quantile(0.95),
                "p99": self.quantile(0.99)}

    def snapshot(self) -> Dict[str, Any]:
        """JSON-safe summary: count/sum/avg/min/max + p50/p95/p99."""
        with self._lock:
            n, tot = self.count, self.total
            vmin, vmax = self.vmin, self.vmax
        out = {"count": n, "sum": tot, "avg": tot / n if n else 0.0,
               "min": vmin if n else 0.0, "max": vmax if n else 0.0}
        out.update(self.percentiles())
        return out


_HISTOGRAMS: Dict[str, Histogram] = {}
_lock = threading.Lock()


def histogram(name: str, low: float = 1e-6, high: float = 1e4,
              bins_per_decade: int = 16) -> Histogram:
    """Get-or-create the process-wide histogram ``name``."""
    with _lock:
        h = _HISTOGRAMS.get(name)
        if h is None:
            h = _HISTOGRAMS[name] = Histogram(low, high, bins_per_decade)
        return h
