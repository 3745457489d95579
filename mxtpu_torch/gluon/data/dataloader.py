"""DataLoader of the PyTorch port (counterpart of
``mxtpu/gluon/data/dataloader.py``; MXNet's ``gluon/data/dataloader.py``).

* ``num_workers=0``: the batches are made inline, under the retry policy
  of ``resilience.run_with_retry``.
* Threads (``thread_pool=True``, the default): ``num_workers`` threads
  make the batches with bounded in-order prefetch; a batch whose thread
  raised is made again inline, and a second failure raises with the
  worker's error chained.  An iterator that ends or is abandoned waits
  for its threads to end, so that none is inside a device call when a
  later loader forks its process workers (a forked child copies the
  locks such a thread holds, and its pool then never answers).
* Forked processes (``thread_pool=False``): workers batchify to numpy
  only (``_np_batchify``) and the parent makes the arrays.  A worker
  refuses samples that are NDArrays (the device belongs to the parent)
  with an ordinary worker error.  A worker's exception crosses back as
  a tagged tuple with its traceback; the batch is retried once in a
  fresh worker, then made in the parent (where NDArray samples batch
  as they do inline), and only then raised with the original
  traceback, as the JAX package does.  A worker that dies (SIGKILL, a
  crash) loses its batch silently in ``multiprocessing.Pool``; the loss
  is seen by the change of the pool's pids (``_WorkerLost``) and the
  batch resubmitted once to the replenished pool.
* ``state()``/``set_state``: the position (epoch, batches handed out,
  seed); a fresh loader with a seeded sampler re-enters the same batch
  stream without touching the dataset for the skipped batches.
* ``MXTPU_PREFETCH_DEVICE=N``: a thread runs ``N`` batches ahead and
  waits for each batch's arrays on a CUDA event of its current stream
  (``_force_device``; never a whole-device ``synchronize()``); its
  errors cross to the consumer, through a full queue too.

Each fetch is timed by ``telemetry.input_wait``.  The JAX package's
fault injection (``resilience.maybe_fault``) and its profiler counters
(``profiler.inc_stat``) are not ported (ROADMAP A17, A18).
"""
from __future__ import annotations

import multiprocessing
import os
import queue
import threading
import time
import traceback

import numpy as np
import torch

from ...base import MXNetError
from ... import resilience as _res
from ...ndarray.ndarray import NDArray, array as nd_array
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn"]

# seconds an abandoned iterator waits for its threads to end, or for the
# batches its process workers are sending
_JOIN_TIMEOUT = 60.0


def default_batchify_fn(data):
    """Stack samples into a batch (MXNet's default_batchify_fn)."""
    if isinstance(data[0], NDArray):
        from ...ndarray import stack

        return stack(*data, axis=0)
    if isinstance(data[0], tuple):
        data = zip(*data)
        return [default_batchify_fn(list(i)) for i in data]
    arr = np.asarray(data)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return nd_array(arr)


def _np_batchify(data):
    """Worker-side batchify: numpy only (a worker never touches torch:
    the device belongs to the parent)."""
    if isinstance(data[0], NDArray):
        raise MXNetError(
            "process workers (thread_pool=False) need datasets that "
            "return numpy or python samples: NDArray samples would pull "
            "the device runtime into the forked worker; use "
            "thread_pool=True (default) or return numpy from "
            "__getitem__")
    if isinstance(data[0], tuple):
        return tuple(_np_batchify(list(i)) for i in zip(*data))
    arr = np.asarray(data)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return arr


_WORKER_DATASET = None


def _worker_init(dataset):
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


# the tag a forked worker returns instead of raising: an exception
# crosses the pickle boundary as text, with its original traceback
_ERR_TAG = "__mxtpu_worker_error__"


class _WorkerLost(Exception):
    """A pool worker died while holding a batch: its result will never
    arrive."""


def _worker_fn(args):
    idx_batch, batchify = args
    try:
        samples = [_WORKER_DATASET[i] for i in idx_batch]
        return batchify(samples)
    except Exception as e:
        return (_ERR_TAG, type(e).__name__, str(e),
                traceback.format_exc())


def _pool_pids(pool):
    return {p.pid for p in getattr(pool, "_pool", [])}


def _await_async(pool, res, submit_pids, poll: float = 0.2,
                 grace: float = 2.0):
    """``res.get()`` that cannot hang: a worker that dies is replaced by
    the pool and its task dropped.  A death shows as a change of the
    pool's pid set against ``submit_pids`` (taken when the batch was
    submitted) or a dead worker; if the result is still pending
    ``grace`` seconds after that, it is lost (:class:`_WorkerLost`)."""
    death_seen = None
    while True:
        try:
            return res.get(poll)
        except multiprocessing.TimeoutError:
            procs = list(getattr(pool, "_pool", []))
            cur = {p.pid for p in procs}
            if cur != submit_pids or any(not p.is_alive() for p in procs):
                if death_seen is None:
                    death_seen = time.monotonic()
            if death_seen is not None and \
                    time.monotonic() - death_seen >= grace:
                if res.ready():
                    return res.get(0)
                raise _WorkerLost()


def _to_nd(batch):
    if isinstance(batch, tuple):
        return [_to_nd(b) for b in batch]
    if isinstance(batch, np.ndarray):
        return nd_array(batch)
    return batch


class DataLoader(object):
    def __init__(self, dataset, batch_size=None, shuffle=False,
                 sampler=None, last_batch=None, batch_sampler=None,
                 batchify_fn=None, num_workers=0, pin_memory=False,
                 prefetch=None, thread_pool=True, seed=None):
        self._dataset = dataset
        self._seed = seed
        if batch_sampler is None:
            if batch_size is None:
                raise MXNetError("batch_size is required when batch_sampler "
                                 "is not given")
            if sampler is None:
                sampler = RandomSampler(len(dataset), seed=seed) if shuffle \
                    else SequentialSampler(len(dataset))
            elif shuffle:
                raise MXNetError("shuffle must be False with custom sampler")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        elif batch_size is not None or shuffle or sampler is not None or \
                last_batch is not None:
            raise MXNetError("batch_size/shuffle/sampler/last_batch must "
                             "not be set when batch_sampler is given")
        self._sampler = sampler if sampler is not None else \
            getattr(batch_sampler, "_sampler", None)
        self._batch_sampler = batch_sampler
        self._batchify_fn = batchify_fn or default_batchify_fn
        self._num_workers = max(0, num_workers)
        self._thread_pool = thread_pool
        self._prefetch = max(0, prefetch if prefetch is not None
                             else 2 * self._num_workers)
        # the position: (epoch, batches handed out this epoch)
        self._epoch = 0
        self._pos_epoch = 0
        self._pos_batch = 0
        self._resume = None

    # -- the position ------------------------------------------------------
    def state(self):
        """The position as a JSON-able dict: ``epoch``, ``batch`` (the
        batches already handed out this epoch, the index of the next)
        and the shuffle ``seed``."""
        return {"epoch": int(self._pos_epoch),
                "batch": int(self._pos_batch),
                "seed": self._seed}

    def set_state(self, state) -> None:
        """Re-enter at a ``state()`` position: the next ``__iter__``
        shuffles for that epoch (seeded sampler) and skips the first
        ``batch`` index batches without touching the dataset."""
        if state is None:
            return
        saved_seed = state.get("seed")
        if saved_seed is not None and self._seed is not None and \
                saved_seed != self._seed:
            raise MXNetError(
                "DataLoader.set_state: shuffle seed mismatch (saved %r, "
                "this loader %r): the restored position would replay a "
                "different batch stream" % (saved_seed, self._seed))
        self._resume = (int(state.get("epoch", 0)),
                        int(state.get("batch", 0)))

    def _make_batch(self, indices):
        return self._batchify_fn([self._dataset[i] for i in indices])

    def __iter__(self):
        from ... import telemetry as _tel

        if self._resume is not None:
            epoch, skip = self._resume
            self._resume = None
        else:
            epoch, skip = self._epoch, 0
        if getattr(self._sampler, "seed", None) is not None:
            # the loader owns the shuffle's epoch, so an abandoned
            # iterator or a restore cannot desynchronise the stream
            self._sampler.set_epoch(epoch)
        self._epoch = epoch
        self._pos_epoch = epoch
        self._pos_batch = skip
        it = self._iter_impl(skip)
        depth = int(os.environ.get("MXTPU_PREFETCH_DEVICE", "0") or 0)
        if depth > 0:
            it = self._device_prefetch_iter(it, depth)
        while True:
            try:
                with _tel.input_wait():
                    batch = next(it)
            except StopIteration:
                self._epoch = epoch + 1
                return
            self._pos_batch += 1
            yield batch

    @staticmethod
    def _force_device(batch):
        """Wait until a batch's arrays are on the card: one CUDA event on
        the current stream of each device the batch lies on."""
        devices = set()

        def collect(b):
            if isinstance(b, (list, tuple)):
                for x in b:
                    collect(x)
            elif isinstance(b, NDArray) and b._data.is_cuda:
                devices.add(b._data.device)

        collect(batch)
        for dev in devices:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(dev))
            event.synchronize()
        return batch

    def _device_prefetch_iter(self, it, depth: int):
        """A daemon thread runs ``depth`` batches ahead, making each and
        waiting for it on the card, behind a bounded queue.  Errors
        cross over and raise in the consumer; an abandoned consumer
        frees the thread through the stop event (the puts poll it)."""
        out_q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        stop = threading.Event()
        done = object()

        def put(item):
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for batch in it:
                    self._force_device(batch)
                    if not put((batch, None)):
                        return
                put((done, None))
            except BaseException as e:  # raised in the consumer
                # the error's put survives a full queue as a batch's does
                put((done, e))

        t = threading.Thread(target=worker, daemon=True,
                             name="mxtpu-device-prefetch")
        t.start()
        try:
            while True:
                batch, err = out_q.get()
                if batch is done:
                    if err is not None:
                        raise err
                    return
                yield batch
        finally:
            stop.set()
            t.join(_JOIN_TIMEOUT)

    def _iter_impl(self, skip: int = 0):
        if self._num_workers == 0:
            it = iter(self._batch_sampler)
            for _ in range(skip):  # re-entry: skip the indices only
                if next(it, None) is None:
                    return
            for indices in it:
                yield _res.run_with_retry(
                    "dataloader", lambda idx=indices: self._make_batch(idx))
            return
        if self._thread_pool:
            yield from self._threaded_iter(skip)
        else:
            yield from self._process_iter(skip)

    def _process_iter(self, skip: int = 0):
        """Forked worker processes: the samples and the numpy batch are
        made in the workers, the arrays in the parent.  A custom
        ``batchify_fn`` runs in the worker and must be picklable and
        numpy-only; the default is swapped for the numpy one."""
        batchify = self._batchify_fn
        if batchify is default_batchify_fn:
            batchify = _np_batchify
        ctx = multiprocessing.get_context("fork")
        batches = list(self._batch_sampler)[skip:]
        pool = ctx.Pool(min(self._num_workers, max(1, len(batches))),
                        initializer=_worker_init,
                        initargs=(self._dataset,))
        # at most max(prefetch, num_workers) batches ahead of the consumer
        window = max(self._prefetch, self._num_workers)

        def _submit(indices):
            return (indices,
                    pool.apply_async(_worker_fn, ((indices, batchify),)),
                    _pool_pids(pool))

        pending = []  # (indices, AsyncResult, the pids at submit)
        try:
            submit = 0
            while submit < len(batches) and len(pending) < window:
                pending.append(_submit(batches[submit]))
                submit += 1
            while pending:
                indices, res, pids = pending.pop(0)
                out = self._resolve_pooled(pool, batchify, indices, res,
                                           pids)
                if submit < len(batches):
                    pending.append(_submit(batches[submit]))
                    submit += 1
                yield _to_nd(out)
        finally:
            # a worker killed while it sends a batch leaves the result
            # queue's lock held, and terminate() then waits for it
            # forever: the batches in flight arrive first
            deadline = time.monotonic() + _JOIN_TIMEOUT
            for _, res, _ in pending:
                res.wait(max(0.0, deadline - time.monotonic()))
            pool.terminate()
            pool.join()

    def _resolve_pooled(self, pool, batchify, indices, res, pids,
                        attempt=0):
        try:
            out = _await_async(pool, res, pids)
        except _WorkerLost:
            if attempt >= 1:
                raise MXNetError(
                    "DataLoader worker process died twice while making "
                    "the same batch (indices %r)" % (indices,))
            retry = pool.apply_async(_worker_fn, ((indices, batchify),))
            return self._resolve_pooled(pool, batchify, indices, retry,
                                        _pool_pids(pool), attempt + 1)
        if isinstance(out, tuple) and len(out) == 4 and out[0] == _ERR_TAG:
            _, etype, emsg, tb = out
            if attempt >= 1:
                # a fresh worker failed too: the parent makes the batch
                # under the retry policy; only then the original error
                try:
                    return _res.run_with_retry(
                        "dataloader", lambda: self._make_batch(indices))
                except Exception:
                    raise MXNetError(
                        "DataLoader worker raised %s: %s (retried in a "
                        "fresh worker and in the parent)\n"
                        "--- original worker traceback ---\n%s"
                        % (etype, emsg, tb))
            retry = pool.apply_async(_worker_fn, ((indices, batchify),))
            return self._resolve_pooled(pool, batchify, indices, retry,
                                        _pool_pids(pool), attempt + 1)
        return out

    def _threaded_iter(self, skip: int = 0):
        """Thread-pool pipeline with bounded in-order prefetch."""
        batches = list(self._batch_sampler)[skip:]
        results: "queue.Queue" = queue.Queue()
        lock = threading.Lock()
        next_submit = [0]
        stop = threading.Event()
        # how far the workers may run ahead of the consumer
        budget = threading.Semaphore(max(self._prefetch, self._num_workers))

        def worker():
            while True:
                budget.acquire()
                if stop.is_set():
                    return
                with lock:
                    i = next_submit[0]
                    if i >= len(batches):
                        budget.release()
                        return
                    next_submit[0] += 1
                try:
                    out = self._make_batch(batches[i])
                    results.put((i, out, None))
                except Exception as e:  # raised in the consumer
                    results.put((i, None, e))

        n_threads = min(self._num_workers, max(1, len(batches)))
        threads = [threading.Thread(target=worker, daemon=True,
                                    name="mxtpu-dataloader")
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        try:
            stash = {}
            for want in range(len(batches)):
                while want not in stash:
                    i, out, err = results.get()
                    stash[i] = (out, err)
                out, err = stash.pop(want)
                if err is not None:
                    # made again inline under the retry policy; a second
                    # failure raises with the worker's error chained
                    try:
                        out = _res.run_with_retry(
                            "dataloader",
                            lambda w=want: self._make_batch(batches[w]))
                    except Exception:
                        raise MXNetError(
                            "DataLoader batch %d failed twice; original "
                            "worker error: %r" % (want, err)) from err
                yield out
                budget.release()  # one consumed: one more may go ahead
        finally:
            # wake blocked workers, so that they end when the consumer
            # abandons the generator or a batch raised; wait for those
            # making a batch, so that no worker is inside a device call
            # when the caller goes on (a fork then copies its locks)
            stop.set()
            for _ in threads:
                budget.release()
            for t in threads:
                t.join(_JOIN_TIMEOUT)

    def __len__(self):
        return len(self._batch_sampler)
