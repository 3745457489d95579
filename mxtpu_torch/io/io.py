"""Data iteration of the PyTorch port (counterpart of ``DataDesc``,
``DataBatch``, ``DataIter`` and ``NDArrayIter`` in ``mxtpu/io/io.py``).
Batches are made on the host and become NDArrays on ``ctx`` (default:
the card) as they are taken."""
from __future__ import annotations

from collections import namedtuple

import numpy as np

from ..base import MXNetError
from ..ndarray.ndarray import NDArray, array as nd_array

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter"]


class DataDesc(namedtuple("DataDesc", ["name", "shape"])):
    """Name, shape, dtype and layout of one input."""

    def __new__(cls, name, shape, dtype=np.float32, layout="NCHW"):
        ret = super(DataDesc, cls).__new__(cls, name, tuple(shape))
        ret.dtype = dtype
        ret.layout = layout
        return ret

    def __repr__(self):
        return "DataDesc[%s,%s,%s,%s]" % (self.name, self.shape, self.dtype,
                                          self.layout)


class DataBatch(object):
    """A mini-batch: a list of data arrays and a list of label arrays."""

    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        if data is not None and not isinstance(data, (list, tuple)):
            raise MXNetError("DataBatch.data must be a list of arrays")
        if label is not None and not isinstance(label, (list, tuple)):
            raise MXNetError("DataBatch.label must be a list of arrays")
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label


class DataIter(object):
    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def __next__(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=None)
        raise StopIteration

    next = __next__

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getpad(self):
        return 0


def _as_named_list(data, default_name):
    if data is None:
        return []
    if isinstance(data, (np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, (list, tuple)):
        names = [default_name] if len(data) == 1 else \
            ["_%d_%s" % (i, default_name) for i in range(len(data))]
        data = dict(zip(names, data))
    out = []
    for k, v in data.items():
        v = v.asnumpy() if isinstance(v, NDArray) else np.asarray(v)
        out.append((k, v.astype(np.float32) if v.dtype == np.float64 else v))
    return out


class NDArrayIter(DataIter):
    """Batches of in-memory arrays, in order or shuffled; the last batch
    is ``pad``ded (wrapping around, ``getpad`` says how far) or
    ``discard``ed.  ``roll_over`` is not ported."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label", ctx=None):
        super().__init__(batch_size)
        self.data = _as_named_list(data, data_name)
        self.label = _as_named_list(label, label_name)
        self.num_data = self.data[0][1].shape[0]
        for k, v in self.data + self.label:
            if v.shape[0] != self.num_data:
                raise MXNetError("inconsistent first dims: %s" % k)
        if last_batch_handle not in ("pad", "discard"):
            raise MXNetError("last_batch_handle %r is not ported"
                             % last_batch_handle)
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.ctx = ctx
        self.idx = np.arange(self.num_data)
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.label]

    def reset(self):
        self.cursor = -self.batch_size
        if self.shuffle:
            np.random.shuffle(self.idx)

    def iter_next(self):
        self.cursor += self.batch_size
        if self.last_batch_handle == "discard":
            return self.cursor + self.batch_size <= self.num_data
        return self.cursor < self.num_data

    def _take(self, arrays):
        lo, hi = self.cursor, self.cursor + self.batch_size
        sel = self.idx[lo:hi] if hi <= self.num_data else np.concatenate(
            [self.idx[lo:], self.idx[:hi - self.num_data]])
        return [nd_array(v[sel], ctx=self.ctx) for _, v in arrays]

    def getdata(self):
        return self._take(self.data)

    def getlabel(self):
        return self._take(self.label) if self.label else []

    def getpad(self):
        hi = self.cursor + self.batch_size
        if self.last_batch_handle == "pad" and hi > self.num_data:
            return hi - self.num_data
        return 0
