"""Data iteration of the PyTorch port (counterpart of
``mxtpu/io/io.py``: ``DataDesc``, ``DataBatch``, ``DataIter``,
``NDArrayIter``, ``SimpleIter``, ``ResizeIter``, ``PrefetchingIter``,
``CSVIter``, ``LibSVMIter``, ``MNISTIter`` and ``create``).  Batches
are made on the host and become NDArrays (CSR arrays for
``LibSVMIter``) on ``ctx`` (default: the card) as they are taken.
``PrefetchingIter`` runs its producer tasks on the dependency engine
(``mxtpu_torch/engine.py``), as the JAX package's does."""
from __future__ import annotations

import gzip
import queue
import struct
from collections import namedtuple

import numpy as np

from ..base import MXNetError
from ..ndarray.ndarray import NDArray, array as nd_array

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "CSVIter", "LibSVMIter", "MNISTIter",
           "SimpleIter", "create"]


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
    """Batches of in-memory arrays, in order or shuffled.  The last
    short batch is ``pad``ded (wrapping around, ``getpad`` says how
    far), ``discard``ed, or, with ``roll_over``, carried: its examples
    lead the next epoch's first batch (whose ``getpad`` counts them)."""

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
        if last_batch_handle not in ("pad", "discard", "roll_over"):
            raise MXNetError("bad last_batch_handle %r" % last_batch_handle)
        if last_batch_handle == "roll_over" and \
                0 < self.num_data < batch_size:
            raise MXNetError("roll_over requires num_data >= batch_size"
                             " (%d < %d)" % (self.num_data, batch_size))
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.ctx = ctx
        self.idx = np.arange(self.num_data)
        self.cursor = -batch_size
        self._cache = None
        self._exhausted = False
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
        # under roll_over an unfinished tail is carried (by its indices
        # before the next shuffle) into the next epoch's first batch
        if self.last_batch_handle == "roll_over" and \
                self.num_data - self.batch_size < self.cursor \
                < self.num_data:
            self._cache = self.idx[self.cursor:].copy()
            self.cursor = self.cursor - self.num_data - self.batch_size
        else:
            self._cache = None
            self.cursor = -self.batch_size
        self._exhausted = False
        if self.shuffle:
            np.random.shuffle(self.idx)

    def iter_next(self):
        if self._exhausted:
            return False
        self.cursor += self.batch_size
        if self.last_batch_handle == "discard":
            ok = self.cursor + self.batch_size <= self.num_data
        elif self.last_batch_handle == "roll_over":
            ok = self.cursor < 0 or \
                self.cursor + self.batch_size <= self.num_data
        else:
            ok = self.cursor < self.num_data
        self._exhausted = not ok
        return ok

    def _selection(self):
        lo, hi = self.cursor, self.cursor + self.batch_size
        if lo < 0:
            return np.concatenate([self._cache, self.idx[:hi]])
        if hi <= self.num_data:
            return self.idx[lo:hi]
        return np.concatenate([self.idx[lo:], self.idx[:hi - self.num_data]])

    def _take(self, arrays):
        sel = self._selection()
        return [nd_array(v[sel], ctx=self.ctx) for _, v in arrays]

    def getdata(self):
        return self._take(self.data)

    def getlabel(self):
        return self._take(self.label) if self.label else []

    def getpad(self):
        hi = self.cursor + self.batch_size
        if self.last_batch_handle == "pad" and hi > self.num_data:
            return hi - self.num_data
        if self.last_batch_handle == "roll_over" and self.cursor < 0:
            return -self.cursor
        return 0

    def getindex(self):
        return self._selection()

    def __next__(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    next = __next__


class SimpleIter(DataIter):
    """``num_batches`` batches a epoch from ``gen_fn(i)``, which returns
    (data arrays, label arrays) of batch ``i``."""

    def __init__(self, provide_data, provide_label, gen_fn, num_batches,
                 ctx=None):
        super().__init__(provide_data[0].shape[0])
        self.provide_data = provide_data
        self.provide_label = provide_label
        self._gen_fn = gen_fn
        self._num = num_batches
        self._i = 0
        self.ctx = ctx

    def reset(self):
        self._i = 0

    def __next__(self):
        if self._i >= self._num:
            raise StopIteration
        self._i += 1
        data, label = self._gen_fn(self._i - 1)
        return DataBatch(data=[nd_array(d, ctx=self.ctx) for d in data],
                         label=[nd_array(x, ctx=self.ctx) for x in label],
                         pad=0, index=None, provide_data=self.provide_data,
                         provide_label=self.provide_label)

    next = __next__


class ResizeIter(DataIter):
    """``size`` batches a epoch of ``data_iter``, which is reset when it
    ends early (and at each ``reset`` with ``reset_internal``)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def __next__(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    next = __next__

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class PrefetchingIter(DataIter):
    """The batches of one or more iterators (merged into one batch a
    step), taken ahead of the consumer by producer tasks on the
    dependency engine (``engine.get_engine()``), one batch a task, at
    most ``prefetch_depth`` of them ahead.  The tasks write one engine
    variable, so they run in order: under the threaded engine on its
    worker threads, beside the consumer; under ``NaiveEngine`` each at
    its push.  ``reset`` and ``close`` wait for every task pushed; an
    error in a task is raised by ``next``."""

    def __init__(self, iters, rename_data=None, rename_label=None,
                 prefetch_depth=2):
        from .. import engine as _engine_mod

        if not isinstance(iters, (list, tuple)):
            iters = [iters]
        super().__init__(iters[0].batch_size)
        self.iters = iters
        self.rename_data = rename_data
        self.rename_label = rename_label
        self._engine = _engine_mod.get_engine()
        self._var = self._engine.new_var()
        self._depth = max(1, int(prefetch_depth))
        self._queue = queue.Queue()
        self._prime()

    @property
    def provide_data(self):
        if self.rename_data is None:
            return sum([i.provide_data for i in self.iters], [])
        return sum([[DataDesc(r.get(d.name, d.name), d.shape, d.dtype)
                     for d in i.provide_data]
                    for r, i in zip(self.rename_data, self.iters)], [])

    @property
    def provide_label(self):
        if self.rename_label is None:
            return sum([i.provide_label for i in self.iters], [])
        return sum([[DataDesc(r.get(d.name, d.name), d.shape, d.dtype)
                     for d in i.provide_label]
                    for r, i in zip(self.rename_label, self.iters)], [])

    def _produce_one(self):
        """One task: a batch of every iterator onto the queue, or None
        (the end), or the error raised."""
        try:
            batches = [i.next() for i in self.iters]
        except StopIteration:
            self._queue.put(None)
            return
        except Exception as e:  # raised again by next()
            self._queue.put(e)
            return
        self._queue.put(batches)

    def _schedule(self):
        self._engine.push(self._produce_one, mutable_vars=[self._var])

    def _prime(self):
        self._seen_end = False
        for _ in range(self._depth):
            self._schedule()

    def close(self):
        """Wait for every task pushed and drop what they made."""
        self._engine.wait_for_var(self._var)
        while True:
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break

    def reset(self):
        self.close()
        for i in self.iters:
            i.reset()
        self._prime()

    def __next__(self):
        if self._seen_end:
            raise StopIteration
        got = self._queue.get()
        if got is None or isinstance(got, Exception):
            self._seen_end = True
            if got is None:
                raise StopIteration
            raise got
        self._schedule()  # keep prefetch_depth batches in flight
        if len(got) == 1:
            return got[0]
        return DataBatch(
            data=sum([b.data for b in got], []),
            label=sum([(b.label or []) for b in got], []),
            pad=max(b.pad or 0 for b in got),
            provide_data=self.provide_data,
            provide_label=self.provide_label)

    next = __next__


def _shape_arg(shape):
    if isinstance(shape, (tuple, list)):
        return tuple(int(s) for s in shape)
    return tuple(int(s) for s in str(shape).strip("()[] ").split(",")
                 if s.strip())


class CSVIter(DataIter):
    """Rows of a CSV file reshaped to ``data_shape`` (labels from
    ``label_csv``, else zeros), batched as ``NDArrayIter`` batches them:
    ``round_batch`` pads the last batch, else it is dropped."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=1, round_batch=True, dtype="float32", ctx=None,
                 **_):
        super().__init__(batch_size)
        self.data_shape = _shape_arg(data_shape)
        self.label_shape = _shape_arg(label_shape)
        data = np.loadtxt(data_csv, delimiter=",", dtype=np.dtype(dtype),
                          ndmin=2).reshape((-1,) + self.data_shape)
        if label_csv is not None:
            label = np.loadtxt(label_csv, delimiter=",", dtype=np.float32,
                               ndmin=2).reshape((-1,) + self.label_shape)
        else:
            label = np.zeros((data.shape[0],) + self.label_shape,
                             dtype=np.float32)
        self._inner = NDArrayIter(
            {"data": data}, {"label": label}, batch_size=batch_size,
            last_batch_handle="pad" if round_batch else "discard", ctx=ctx)

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


_ITER_REGISTRY = {
    "MNISTIter": MNISTIter,
    "CSVIter": CSVIter,
    "LibSVMIter": LibSVMIter,
    "NDArrayIter": NDArrayIter,
}


def create(name, **kwargs):
    """A registered iterator by name (``MNISTIter``, ``CSVIter``,
    ``LibSVMIter``, ``NDArrayIter``)."""
    if name not in _ITER_REGISTRY:
        raise MXNetError("unknown data iter %r (have %s)"
                         % (name, sorted(_ITER_REGISTRY)))
    return _ITER_REGISTRY[name](**kwargs)
