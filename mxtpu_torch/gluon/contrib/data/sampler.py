"""Experimental samplers of the PyTorch port (counterpart of
``mxtpu/gluon/contrib/data/sampler.py``)."""
from __future__ import annotations

from ...data.sampler import Sampler

__all__ = ["IntervalSampler"]


class IntervalSampler(Sampler):
    """Sample at fixed intervals, rolling the start offset: for length
    6, interval 2 yields 0,2,4,1,3,5."""

    def __init__(self, length, interval, rollover=True):
        if interval > length:  # interval == length is legal
            raise ValueError("interval (%d) must be <= length (%d)"
                             % (interval, length))
        self._length = length
        self._interval = interval
        self._rollover = rollover

    def __iter__(self):
        starts = range(self._interval) if self._rollover else [0]
        for start in starts:
            for i in range(start, self._length, self._interval):
                yield i

    def __len__(self):
        if self._rollover:
            return self._length
        return len(range(0, self._length, self._interval))
