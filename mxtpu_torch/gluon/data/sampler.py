"""Samplers of the PyTorch port (counterpart of
``mxtpu/gluon/data/sampler.py``; MXNet's ``gluon/data/sampler.py``).
A seeded ``RandomSampler``'s permutation of epoch ``e`` is numpy's
``RandomState((seed + 0x9E3779B1 * e) mod (2**31 - 1))``, so its index
stream is the JAX package's, index for index."""
from __future__ import annotations

import numpy as np

from ...base import MXNetError

__all__ = ["Sampler", "SequentialSampler", "RandomSampler", "BatchSampler"]


class Sampler(object):
    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class SequentialSampler(Sampler):
    def __init__(self, length):
        self._length = length

    def __iter__(self):
        return iter(range(self._length))

    def __len__(self):
        return self._length


class RandomSampler(Sampler):
    """Uniform shuffle.  With ``seed`` set the permutation of epoch ``e``
    is a pure function of ``(seed, e)``, so a DataLoader restored at a
    ``(seed, epoch, batch)`` position regenerates the identical index
    stream mid-epoch; with ``seed=None`` (default) the global numpy
    generator shuffles."""

    def __init__(self, length, seed=None):
        self._length = length
        self._seed = seed
        self._epoch = 0

    @property
    def seed(self):
        return self._seed

    def set_epoch(self, epoch) -> None:
        """Pin which epoch the NEXT `__iter__` shuffles for (resume
        re-entry; no-op for unseeded samplers, whose stream is not
        reconstructible anyway)."""
        self._epoch = int(epoch)

    def __iter__(self):
        if self._seed is None:
            indices = np.random.permutation(self._length)
        else:
            rng = np.random.RandomState(
                (int(self._seed) + 0x9E3779B1 * self._epoch)
                % (2 ** 31 - 1))
            indices = rng.permutation(self._length)
        self._epoch += 1
        return iter(indices.tolist())

    def __len__(self):
        return self._length


class BatchSampler(Sampler):
    """Wrap a sampler into batches; last_batch in {keep, discard, rollover}
    (reference BatchSampler)."""

    def __init__(self, sampler, batch_size, last_batch="keep"):
        self._sampler = sampler
        self._batch_size = batch_size
        self._last_batch = last_batch
        self._prev = []
        if last_batch not in ("keep", "discard", "rollover"):
            raise MXNetError(
                "last_batch must be one of keep/discard/rollover, got %r"
                % last_batch)

    def __iter__(self):
        batch, self._prev = self._prev, []
        for i in self._sampler:
            batch.append(i)
            if len(batch) == self._batch_size:
                yield batch
                batch = []
        if batch:
            if self._last_batch == "keep":
                yield batch
            elif self._last_batch == "rollover":
                self._prev = batch

    def __len__(self):
        if self._last_batch == "keep":
            return (len(self._sampler) + self._batch_size - 1) // \
                self._batch_size
        if self._last_batch == "discard":
            return len(self._sampler) // self._batch_size
        return (len(self._sampler) + len(self._prev)) // self._batch_size
