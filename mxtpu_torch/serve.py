"""Continuous-batching model server of the PyTorch port.

Counterpart of ``mxtpu/serve.py``: ``_Future``, ``_Request``,
``_ModelEntry`` and ``Server`` with its continuous micro-batcher.

  * **Request/future plumbing** -- :meth:`Server.submit` enqueues a
    request (one or more rows of one model's input) and returns a
    future; :meth:`Server.infer` is the blocking convenience.

  * **Continuous micro-batcher** -- one batcher thread per model pops
    the queue and packs ragged in-flight requests into the pow2 (or
    ``mult:N``/``fixed:...``) bucket set, zero-padding to the bucket and
    dispatching ONE call of the model per batch.  New requests are
    admitted at every bucket boundary; the batcher lingers at most
    ``MXTPU_SERVE_BATCH_WAIT_US`` when the queue runs dry below the cap.

  * **Admission control and degradation** -- per-(model, tenant)
    queued-row caps shed excess load with the typed
    :class:`~mxtpu_torch.base.RequestShedError` (reason ``queue_full``,
    ``draining`` or ``timeout``).  Device-memory exhaustion
    (``torch.cuda.OutOfMemoryError``, or a :class:`MemoryExhaustedError`
    or ``MemoryError`` from the model) SHRINKS the model's bucket cap to
    the next smaller bucket and requeues the batch; at the smallest
    bucket the batch fails typed.

A model is a plain callable ``fn(np.ndarray[batch, ...]) -> np.ndarray``
with batch-major outputs (or a tuple of them), or a ``torch.nn.Module``
(where the gluon block stood in the JAX module), which
``Server._as_predict`` wraps into one.  Request latency lands in
a per-model :class:`~mxtpu_torch.telemetry.Histogram`; :meth:`metrics`
reports p50/p95/p99 with the queue and batch gauges.

Not ported yet: the JAX module's hooks into ``tune``, ``hbm``, ``perf``,
``tracing``, ``profiler``, ``resilience`` and ``telemetry.record``
(ROADMAP A17/A18), and ``HttpFrontend``, ``Client``, ``serve_forever``
and ``wait_ready`` (a later slice).
"""
from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .base import MXNetError, RequestShedError, getenv, getenv_int
from . import compile_cache as _cc
from . import telemetry as _tel

__all__ = ["Server"]

# what the dispatch treats as "the device ran out of memory"
# (MemoryExhaustedError is a MemoryError)
_OOM_ERRORS = (MemoryError, torch.cuda.OutOfMemoryError)


def _max_batch_default() -> int:
    return max(1, getenv_int("MXTPU_SERVE_MAX_BATCH", 32))


def _queue_cap_default() -> int:
    return max(1, getenv_int("MXTPU_SERVE_QUEUE_CAP", 1024))


def _batch_wait_default() -> float:
    return max(0.0, getenv_int("MXTPU_SERVE_BATCH_WAIT_US", 2000) / 1e6)


def _timeout_default() -> float:
    return float(getenv("MXTPU_SERVE_TIMEOUT", "30") or 30)


class _Future(object):
    """Result slot for one submitted request."""

    __slots__ = ("_ev", "_val", "_exc")

    def __init__(self):
        self._ev = threading.Event()
        self._val = None
        self._exc: Optional[BaseException] = None

    def _set_result(self, val) -> None:
        self._val = val
        self._ev.set()

    def _set_exception(self, exc: BaseException) -> None:
        self._exc = exc
        self._ev.set()

    def done(self) -> bool:
        return self._ev.is_set()

    def result(self, timeout: Optional[float] = None):
        """Block for the output rows; raises what the server raised (a
        :class:`RequestShedError` for shed requests)."""
        if not self._ev.wait(timeout):
            raise TimeoutError("serve request still pending after %ss"
                               % timeout)
        if self._exc is not None:
            raise self._exc
        return self._val


class _Request(object):
    __slots__ = ("x", "n", "tenant", "future", "t_enq", "deadline")

    def __init__(self, x: np.ndarray, tenant: str, deadline: float):
        self.x = x
        self.n = int(x.shape[0])
        self.tenant = tenant
        self.future = _Future()
        self.t_enq = time.monotonic()
        self.deadline = deadline


class _ModelEntry(object):
    """One hosted model: its predict callable, bucket set, dynamic batch
    cap (OOM-shrinkable), queue and latency histogram."""

    def __init__(self, name: str, predict: Callable[[np.ndarray], Any],
                 dtype: str, sample_shape: Optional[Tuple[int, ...]],
                 max_batch: int, bucket_spec: str, queue_cap: int):
        self.name = name
        self.predict = predict
        self.dtype = np.dtype(dtype)
        self.sample_shape = tuple(sample_shape) if sample_shape else None
        # the EFFECTIVE cap is the largest bucket <= the requested cap,
        # so every dispatch pads to a bucket of the set
        self.buckets = _cc.bucket_set(int(max_batch), bucket_spec)
        self.max_batch = self.buckets[-1]
        self.bucket_spec = bucket_spec
        self.queue_cap = int(queue_cap)
        self.queue: collections.deque = collections.deque()
        self.queued_rows = 0
        self.tenant_rows: Dict[str, int] = {}
        self.lock = threading.Lock()
        self.cond = threading.Condition(self.lock)
        self.inflight_rows = 0
        # full request latency (enqueue -> result), seconds
        self.hist = _tel.histogram("serve_latency_s::%s" % name)
        self.thread: Optional[threading.Thread] = None


class Server(object):
    """In-process continuous-batching model server.

    ::

        srv = mxtpu_torch.serve.Server()
        srv.add_model("lm", next_token_logits, input_shape=(1024,),
                      dtype="int32")
        srv.start()
        out = srv.infer("lm", tokens)   # (rows, ...) outputs

    Thread-safe: :meth:`submit` may be called from any number of
    threads; each model has ONE batcher thread, so per-model dispatch
    is serialized while distinct models run concurrently.
    """

    def __init__(self, max_batch: Optional[int] = None,
                 queue_cap: Optional[int] = None,
                 batch_wait_s: Optional[float] = None,
                 request_timeout_s: Optional[float] = None,
                 bucket_spec: Optional[str] = None):
        self.max_batch = max_batch or _max_batch_default()
        self.queue_cap = queue_cap or _queue_cap_default()
        self.batch_wait_s = _batch_wait_default() \
            if batch_wait_s is None else float(batch_wait_s)
        self.request_timeout_s = _timeout_default() \
            if request_timeout_s is None else float(request_timeout_s)
        self.bucket_spec = bucket_spec or _cc.get_bucket_policy() or "pow2"
        _cc._parse_policy(self.bucket_spec)  # validate eagerly
        self._entries: Dict[str, _ModelEntry] = {}
        self._lock = threading.Lock()
        self._started = False
        self._draining = False
        self._stopped = False
        self._last_occupancy = 0.0

    # -- model hosting -----------------------------------------------------

    def add_model(self, name: str, model: Callable[[np.ndarray], Any],
                  input_shape: Optional[Sequence[int]] = None,
                  dtype: str = "float32",
                  max_batch: Optional[int] = None) -> None:
        """Host ``model`` under ``name``: a ``torch.nn.Module`` or a
        plain callable ``fn(np.ndarray[batch, ...]) -> np.ndarray``
        (batch-major outputs).  ``input_shape`` is ONE sample's shape
        (no batch dim) and ``dtype`` the dtype requests are converted
        to.  Call before :meth:`start` or while running."""
        if self._stopped:
            raise MXNetError("server is stopped")
        cap = int(max_batch or self.max_batch)
        entry = _ModelEntry(name, self._as_predict(model), dtype,
                            input_shape, cap, self.bucket_spec,
                            self.queue_cap)
        with self._lock:
            if name in self._entries:
                raise MXNetError("model %r already hosted" % name)
            self._entries[name] = entry
            if self._started:
                self._start_entry(entry)

    @staticmethod
    def _as_predict(model: Any) -> Callable[[np.ndarray], Any]:
        """A plain callable serves as it is.  A ``torch.nn.Module`` gets
        the rows as a tensor on the device of its first parameter or
        buffer (the CPU if it has none) and runs under
        ``torch.inference_mode()``; its output tensors come back as
        numpy arrays, bfloat16 widened to float32 (numpy has no
        bfloat16)."""
        if not callable(model):
            raise MXNetError("model must be callable, got %r"
                             % type(model))
        if not isinstance(model, torch.nn.Module):
            return model

        def to_numpy(t):
            if t.dtype == torch.bfloat16:
                t = t.float()
            return t.cpu().numpy()

        def predict(x: np.ndarray):
            held = next(itertools.chain(model.parameters(), model.buffers()),
                        None)
            dev = held.device if held is not None else torch.device("cpu")
            with torch.inference_mode():
                out = model(torch.from_numpy(x).to(dev))
            if isinstance(out, (list, tuple)):
                return tuple(to_numpy(o) for o in out)
            return to_numpy(out)
        return predict

    def models(self) -> List[str]:
        with self._lock:
            return sorted(self._entries)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "Server":
        with self._lock:
            if self._started:
                return self
            self._started = True
            for entry in self._entries.values():
                self._start_entry(entry)
        return self

    def _start_entry(self, entry: _ModelEntry) -> None:
        t = threading.Thread(target=self._batcher_loop, args=(entry,),
                             name="mxserve-%s" % entry.name, daemon=True)
        entry.thread = t
        t.start()

    def drain(self, timeout: float = 30.0) -> bool:
        """Graceful shutdown: stop admitting (further :meth:`submit`
        sheds with reason ``draining``), finish everything already
        queued or in flight, then stop the batcher threads.  Returns True
        when fully drained within ``timeout``.  Idempotent."""
        with self._lock:
            self._draining = True
            entries = list(self._entries.values())
        deadline = time.monotonic() + max(0.0, timeout)
        ok = True
        for entry in entries:
            with entry.cond:
                entry.cond.notify_all()
            t = entry.thread
            if t is not None:
                t.join(max(0.0, deadline - time.monotonic()))
                ok = ok and not t.is_alive()
        self._stopped = True
        return ok

    def close(self) -> None:
        """Drain briefly."""
        self.drain(timeout=5.0)

    @property
    def draining(self) -> bool:
        return self._draining

    # -- submission / admission control ------------------------------------

    def submit(self, model: str, x, tenant: str = "default",
               timeout: Optional[float] = None) -> _Future:
        """Enqueue rows for ``model`` and return the future.  ``x`` is
        one sample (``input_shape``) or a batch of rows.  A full
        per-tenant queue or a draining server RAISES the typed
        :class:`RequestShedError` here, on the caller's thread; only a
        deadline expiring in the queue sheds through the future."""
        entry = self._entries.get(model)
        if entry is None:
            raise MXNetError("unknown model %r (hosted: %s)"
                             % (model, self.models()))
        if not self._started:
            # admitting with no batcher thread would orphan the future
            raise MXNetError("server not started: call start() before "
                             "submit()")
        x = np.ascontiguousarray(x, dtype=entry.dtype)
        if entry.sample_shape is not None and \
                x.shape == entry.sample_shape:
            x = x[None]  # one bare sample -> a 1-row batch
        if x.ndim == 0 or x.shape[0] < 1:
            raise MXNetError("request needs at least one row")
        if entry.sample_shape is not None and \
                tuple(x.shape[1:]) != entry.sample_shape:
            raise MXNetError(
                "model %r expects sample shape %s, got rows of %s"
                % (model, entry.sample_shape, tuple(x.shape[1:])))
        budget = self.request_timeout_s if timeout is None else timeout
        req = _Request(x, tenant, time.monotonic() + budget)
        with entry.cond:
            # checked UNDER the batcher's cond: the batcher exits holding
            # it (queue empty + draining), so a check outside could
            # append after the last pop and orphan the future
            if self._draining or self._stopped:
                raise self._shed(entry, req, "draining", deliver=False)
            have = entry.tenant_rows.get(tenant, 0)
            if have + req.n > entry.queue_cap:
                raise self._shed(entry, req, "queue_full", deliver=False)
            entry.queue.append(req)
            entry.queued_rows += req.n
            entry.tenant_rows[tenant] = have + req.n
            entry.cond.notify()
        return req.future

    def infer(self, model: str, x, tenant: str = "default",
              timeout: Optional[float] = None):
        """Blocking :meth:`submit`: returns the output rows."""
        budget = self.request_timeout_s if timeout is None else timeout
        # slack over the queue deadline: an expired request is shed by
        # the batcher with the typed error, not an opaque TimeoutError
        return self.submit(model, x, tenant, timeout).result(budget + 5.0)

    def _shed(self, entry: _ModelEntry, req: _Request, reason: str,
              deliver: bool = True) -> RequestShedError:
        """``deliver=True`` fails the future (the in-queue timeout
        path); ``deliver=False`` returns the error for the submitter to
        raise."""
        err = RequestShedError(
            "request (%d rows, tenant %r, model %r) shed: %s"
            % (req.n, req.tenant, entry.name, reason), reason=reason)
        if deliver:
            req.future._set_exception(err)
        return err

    # -- the micro-batcher -------------------------------------------------

    def _pop_admitted(self, entry: _ModelEntry,
                      fit: Optional[int] = None) -> Optional[_Request]:
        """Pop the queue head (caller holds entry.lock), shedding
        requests whose deadline expired while queued.  With ``fit``, a
        LIVE head wider than ``fit`` rows stays (it starts the NEXT
        bucket) and None is returned; the fit check runs AFTER expiry
        sheds, so a shed head cannot admit an unchecked successor."""
        while entry.queue:
            req = entry.queue[0]
            expired = time.monotonic() > req.deadline
            if not expired and fit is not None and req.n > fit:
                return None
            entry.queue.popleft()
            entry.queued_rows -= req.n
            entry.tenant_rows[req.tenant] = \
                entry.tenant_rows.get(req.tenant, 0) - req.n
            if expired:
                self._shed(entry, req, "timeout")
                continue
            return req
        return None

    def _batcher_loop(self, entry: _ModelEntry) -> None:
        """One thread per model.  CONTINUOUS batching: re-admit from the
        queue at every bucket boundary; linger at most ``batch_wait_s``
        when below the cap with an empty queue."""
        while True:
            with entry.cond:
                while not entry.queue and not self._draining:
                    entry.cond.wait(0.1)
                if not entry.queue and self._draining:
                    return
                first = self._pop_admitted(entry)
            if first is None:
                continue
            batch = [first]
            rows = first.n
            deadline = time.monotonic() + self.batch_wait_s
            while rows < entry.max_batch:
                with entry.cond:
                    if not entry.queue:
                        if self._draining:
                            break
                        wait = deadline - time.monotonic()
                        if wait <= 0:
                            break
                        entry.cond.wait(wait)
                        if not entry.queue:
                            continue  # re-check the deadline
                    if entry.queue[0].n + rows > entry.max_batch:
                        break  # the head starts the NEXT bucket
                    nxt = self._pop_admitted(
                        entry, fit=entry.max_batch - rows)
                if nxt is not None:
                    batch.append(nxt)
                    rows += nxt.n
            self._dispatch(entry, batch, rows)

    def _dispatch(self, entry: _ModelEntry, batch: List[_Request],
                  rows: int) -> None:
        """Pack -> pad to the bucket -> ONE model call -> slice.  Never
        raises: errors land in the request futures, OOM shrinks the
        bucket cap and requeues."""
        xs = batch[0].x if len(batch) == 1 else \
            np.concatenate([r.x for r in batch], axis=0)
        bucket = _cc.bucket_batch(rows, entry.bucket_spec)
        if bucket > entry.max_batch:
            # only a single request wider than the cap gets here (the
            # batcher never packs past it): dispatch it at its own width
            bucket = entry.max_batch
        if bucket > rows:
            pad = np.zeros((bucket - rows,) + xs.shape[1:], dtype=xs.dtype)
            xs = np.concatenate([xs, pad], axis=0)
        with entry.lock:
            entry.inflight_rows = rows
        try:
            out = entry.predict(xs)
        except _OOM_ERRORS as e:
            self._degrade(entry, batch, bucket, e)
            return
        except Exception as e:  # the model's fault fails its requests
            for req in batch:
                req.future._set_exception(e)
            return
        finally:
            with entry.lock:
                entry.inflight_rows = 0
        self._fulfill(entry, batch, rows, bucket, out)

    def _fulfill(self, entry: _ModelEntry, batch: List[_Request],
                 rows: int, bucket: int, out: Any) -> None:
        outs = out if isinstance(out, tuple) else (out,)
        for o in outs:
            lead = getattr(o, "shape", (None,))[0]
            if lead not in (rows, bucket):
                err = MXNetError(
                    "model %r output leading dim %r is neither the packed "
                    "rows (%d) nor the bucket (%d): serve needs "
                    "batch-major outputs" % (entry.name, lead, rows,
                                             bucket))
                for req in batch:
                    req.future._set_exception(err)
                return
        now = time.monotonic()
        off = 0
        for req in batch:
            sliced = tuple(o[off:off + req.n] for o in outs)
            req.future._set_result(
                sliced if isinstance(out, tuple) else sliced[0])
            off += req.n
            entry.hist.record(now - req.t_enq)
        # an overwide single request dispatches raw (rows > bucket)
        self._last_occupancy = 100.0 * rows / max(1, bucket, rows)

    def _degrade(self, entry: _ModelEntry, batch: List[_Request],
                 bucket: int, exc: BaseException) -> None:
        """The OOM path: shrink the model's bucket cap to the next
        smaller bucket, requeue the batch at the front, keep serving.
        A request wider than the shrunken cap, or an OOM already at the
        smallest bucket, fails with the original error: requeueing it
        would redispatch the same doomed batch until its deadline."""
        smaller = [b for b in entry.buckets if b < bucket]
        with entry.cond:
            if smaller:
                entry.max_batch = min(entry.max_batch, smaller[-1])
            requeue = []
            for req in batch:
                if not smaller or req.n > entry.max_batch:
                    req.future._set_exception(exc)
                else:
                    requeue.append(req)
            for req in reversed(requeue):
                entry.queue.appendleft(req)
                entry.queued_rows += req.n
                entry.tenant_rows[req.tenant] = \
                    entry.tenant_rows.get(req.tenant, 0) + req.n
            entry.cond.notify()

    # -- observability -----------------------------------------------------

    def metrics(self) -> Dict[str, Any]:
        """Queue depth, in-flight rows, last batch occupancy, draining,
        and per model its cap and request-latency p50/p95/p99 (seconds).
        The JAX package serves this block as
        ``telemetry.metrics()["serve"]``."""
        with self._lock:
            entries = dict(self._entries)
        per_model = {}
        for name, e in entries.items():
            snap = e.hist.snapshot()
            per_model[name] = {
                "queued_rows": e.queued_rows,
                "inflight_rows": e.inflight_rows,
                "max_batch": e.max_batch,
                "latency_p50_s": snap["p50"],
                "latency_p95_s": snap["p95"],
                "latency_p99_s": snap["p99"],
                "requests": snap["count"],
            }
        return {
            "queue_depth": sum(e.queued_rows for e in entries.values()),
            "inflight": sum(e.inflight_rows for e in entries.values()),
            "batch_occupancy_pct": self._last_occupancy,
            "draining": self._draining,
            "models": per_model,
        }
