"""Data iteration of the PyTorch port (counterpart of ``DataDesc``,
``DataBatch``, ``DataIter``, ``NDArrayIter``, ``LibSVMIter`` and
``MNISTIter`` in ``mxtpu/io/io.py``).  Batches are made on the host
and become NDArrays (CSR arrays for ``LibSVMIter``) on ``ctx``
(default: the card) as they are taken."""
from __future__ import annotations

import gzip
import struct
from collections import namedtuple

import numpy as np

from ..base import MXNetError
from ..ndarray.ndarray import NDArray, array as nd_array

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter",
           "LibSVMIter", "MNISTIter"]


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


class LibSVMIter(DataIter):
    """LibSVM text (``label id:value ...`` a row) as CSR batches
    (reference ``src/io/iter_libsvm.cc``).  The file parses straight into
    host CSR triplets, so a million-feature set costs O(nnz); each batch
    is a ``CSRNDArray`` on ``ctx`` (default: the card) cut from them.
    ``num_parts``/``part_index`` keep every ``num_parts``-th row (a
    shard, which may be empty: it then gives no batch); a separate
    ``label_libsvm`` file (rows of numbers) is sharded the same way.
    With ``round_batch`` the last batch wraps around to the first rows
    and ``pad`` says how many it borrowed; without, it is dropped."""

    def __init__(self, data_libsvm, data_shape, label_libsvm=None,
                 label_shape=None, batch_size=1, round_batch=True,
                 num_parts=1, part_index=0, ctx=None, **_):
        super().__init__(batch_size)
        self.data_shape = tuple(data_shape) if isinstance(
            data_shape, (tuple, list)) else (int(data_shape),)
        self._num_col = int(np.prod(self.data_shape))
        self.round_batch = round_batch
        self.ctx = ctx

        def mine(row_no):
            return num_parts <= 1 or row_no % num_parts == part_index

        labels, cols, vals, indptr = [], [], [], [0]
        row_no = 0  # non-empty rows seen, for the shard
        with open(data_libsvm) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                row_no += 1
                if not mine(row_no - 1):
                    continue
                labels.append([float(parts[0])])
                for kv in parts[1:]:
                    k, v = kv.split(":")
                    cols.append(int(k))
                    vals.append(float(v))
                indptr.append(len(cols))
        if row_no == 0:
            raise MXNetError("no rows in %s" % data_libsvm)
        if label_libsvm is not None:
            labels, lrow = [], 0
            with open(label_libsvm) as f:
                for line in f:
                    if not line.strip():
                        continue
                    lrow += 1
                    if mine(lrow - 1):
                        labels.append([float(t) for t in line.split()])
        self._labels = np.asarray(labels, np.float32) \
            if labels else np.zeros((0, 1), np.float32)
        self._cols = np.asarray(cols, np.int64)
        self._vals = np.asarray(vals, np.float32)
        self._indptr = np.asarray(indptr, np.int64)
        if len(self._labels) != len(self._indptr) - 1:
            raise MXNetError("label rows (%d) != data rows (%d) in %s"
                             % (len(self._labels), len(self._indptr) - 1,
                                data_libsvm))
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size, self._num_col),
                         np.float32)]

    @property
    def provide_label(self):
        lw = self._labels.shape[1]
        shape = (self.batch_size,) if lw == 1 else (self.batch_size, lw)
        return [DataDesc("softmax_label", shape, np.float32)]

    def reset(self):
        self._cursor = 0

    def _csr_batch(self, lo, hi):
        """Rows [lo, hi) of the triplets (wrapping past the end) as a
        CSR array on ``ctx``, and their labels."""
        from ..ndarray import sparse as _sp

        sel = np.arange(lo, hi) % len(self._labels)
        starts = self._indptr[sel]
        counts = self._indptr[sel + 1] - starts
        indptr = np.zeros(len(sel) + 1, np.int64)
        np.cumsum(counts, out=indptr[1:])
        take = np.arange(indptr[-1]) + np.repeat(starts - indptr[:-1],
                                                 counts)
        csr = _sp.csr_matrix((self._vals[take], self._cols[take], indptr),
                             shape=(len(sel), self._num_col), ctx=self.ctx)
        label = self._labels[sel]
        return csr, label[:, 0] if label.shape[1] == 1 else label

    def next(self):
        n = len(self._labels)
        hi = self._cursor + self.batch_size
        if self._cursor >= n or (hi > n and not self.round_batch):
            raise StopIteration
        csr, label = self._csr_batch(self._cursor, hi)
        pad = max(0, hi - n)
        self._cursor = hi
        return DataBatch(data=[csr], label=[nd_array(label, ctx=self.ctx)],
                         pad=pad, provide_data=self.provide_data,
                         provide_label=self.provide_label)

    __next__ = next


def _read_idx_file(path):
    """An IDX (MNIST) file as an array; ``.gz`` files are read through
    gzip."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dtype_code = (magic >> 8) & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        dt = {0x08: np.uint8, 0x09: np.int8, 0x0B: np.int16, 0x0C: np.int32,
              0x0D: np.float32, 0x0E: np.float64}[dtype_code]
        data = np.frombuffer(f.read(), dtype=np.dtype(dt).newbyteorder(">"))
        return data.reshape(dims).astype(dt)


class MNISTIter(DataIter):
    """Batches of MNIST idx (or idx.gz) files: images scaled to [0, 1],
    as (batch, 1, 28, 28), or (batch, 784) with ``flat``; ``shuffle``
    permutes the examples once with ``RandomState(seed)``; the last
    short batch is discarded."""

    def __init__(self, image, label, batch_size=128, shuffle=True, flat=False,
                 silent=False, seed=0, ctx=None, **_):
        super().__init__(batch_size)
        img = _read_idx_file(image).astype(np.float32) / 255.0
        lab = _read_idx_file(label).astype(np.float32)
        if flat:
            img = img.reshape(img.shape[0], -1)
        else:
            img = img.reshape(img.shape[0], 1, img.shape[1], img.shape[2])
        if shuffle:
            order = np.random.RandomState(seed).permutation(img.shape[0])
            img, lab = img[order], lab[order]
        self._inner = NDArrayIter({"data": img}, {"softmax_label": lab},
                                  batch_size=batch_size,
                                  last_batch_handle="discard", ctx=ctx)

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def __next__(self):
        return self._inner.next()

    next = __next__
