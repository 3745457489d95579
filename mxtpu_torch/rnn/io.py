"""BucketSentenceIter of the PyTorch port (counterpart of
``mxtpu/rnn/io.py``).

Sentences (lists of token ids) go into the smallest bucket that holds
them, padded with ``invalid_label``; each batch carries its bucket's
length as ``bucket_key``, and its label is the data shifted one step
left (the next token), ending in ``invalid_label``.  ``reset`` shuffles
the batches with the global ``random`` and each bucket's rows with the
global ``np.random``, the JAX package's draws in its order, so the same
seeds give the same batches in the same order in both packages.
Batches become NDArrays on ``ctx`` (default: the card) as they are
taken.
"""
from __future__ import annotations

import logging
import random as pyrandom
from typing import List

import numpy as np

from ..io.io import DataBatch, DataDesc, DataIter
from ..ndarray.ndarray import array as nd_array

__all__ = ["BucketSentenceIter"]


class BucketSentenceIter(DataIter):
    def __init__(self, sentences, batch_size, buckets=None,
                 invalid_label=-1, data_name="data",
                 label_name="softmax_label", dtype="float32",
                 layout="NT", ctx=None):
        super().__init__(batch_size)
        if not buckets:
            lens = np.bincount([len(s) for s in sentences])
            buckets = [i for i, n in enumerate(lens) if n >= batch_size]
        buckets = sorted(buckets)
        ndiscard = 0
        data: List[List] = [[] for _ in buckets]
        for sent in sentences:
            buck = np.searchsorted(buckets, len(sent))
            if buck == len(buckets):
                ndiscard += 1
                continue
            buff = np.full((buckets[buck],), invalid_label, dtype=dtype)
            buff[:len(sent)] = sent
            data[buck].append(buff)
        self.data = [np.asarray(x, dtype=dtype).reshape(-1, blen)
                     for x, blen in zip(data, buckets)]
        if ndiscard:
            logging.warning("discarded %d sentences longer than the "
                            "largest bucket", ndiscard)
        self.batch_size = batch_size
        self.buckets = buckets
        self.data_name = data_name
        self.label_name = label_name
        self.invalid_label = invalid_label
        self.layout = layout
        self.ctx = ctx
        self.default_bucket_key = max(buckets)
        self.idx = []
        for i, buck in enumerate(self.data):
            self.idx.extend([(i, j) for j in
                             range(0, len(buck) - batch_size + 1,
                                   batch_size)])
        self.curr_idx = 0
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(self.data_name,
                         (self.batch_size, self.default_bucket_key))]

    @property
    def provide_label(self):
        return [DataDesc(self.label_name,
                         (self.batch_size, self.default_bucket_key))]

    def reset(self):
        self.curr_idx = 0
        pyrandom.shuffle(self.idx)
        for buck in self.data:
            np.random.shuffle(buck)
        self.nddata, self.ndlabel = [], []
        for buck in self.data:
            label = np.empty_like(buck)
            label[:, :-1] = buck[:, 1:]
            label[:, -1] = self.invalid_label
            self.nddata.append(buck)
            self.ndlabel.append(label)

    def __next__(self) -> DataBatch:
        if self.curr_idx == len(self.idx):
            raise StopIteration
        i, j = self.idx[self.curr_idx]
        self.curr_idx += 1
        length = self.buckets[i]
        return DataBatch(
            data=[nd_array(self.nddata[i][j:j + self.batch_size],
                           ctx=self.ctx)],
            label=[nd_array(self.ndlabel[i][j:j + self.batch_size],
                            ctx=self.ctx)],
            bucket_key=length,
            provide_data=[DataDesc(self.data_name,
                                   (self.batch_size, length))],
            provide_label=[DataDesc(self.label_name,
                                    (self.batch_size, length))])

    next = __next__
