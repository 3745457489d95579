"""KVStore of the PyTorch port, in one process (counterpart of the
``local`` and ``device`` stores of ``mxtpu/kvstore.py``).

A store keeps one dense array a key on its device (``ctx``, default:
the card).  ``push`` sums the values pushed for a key (``_fused_sum``;
row-sparse values sum into a row-sparse array over the union of their
rows, so that the updater's lazy update stays lazy), compresses a dense
sum when 2-bit compression is set (``GradientCompression``, with its
residual), then either hands it to the updater, which updates the
stored weight, or makes it the stored value.  ``pull`` copies the
stored value into each output; ``row_sparse_pull`` copies only the
requested rows: a row-sparse output holds exactly those rows, a dense
one gets them over zeros (every other row is written too: a full
write of the array a pull, as in the reference).

The distributed stores (``dist_sync``, ``dist_device_sync``,
``dist_async``: :class:`KVStoreDist`) merge a key's values on the card
as ``local`` does, then push the sum to the parameter server
(``_ps.py``) and pull the stored value back: a row-sparse sum goes as a
rows-only push, and ``row_sparse_pull`` fetches only the rows asked
for.  With ``set_optimizer`` the optimizer runs on the servers (rank 0
pickles it; every worker then waits at a barrier).  In sync mode a
server sums the pushes of every worker before it applies them; in
async mode it applies each push.  The roles come from
``MXTPU_ROLE`` and the other ``MXTPU_*``/``DMLC_*`` variables that the
launcher (``python -m mxtpu_torch.tools.launch``) sets.  ``tpu`` (a
collective over a mesh of several devices) is not ported (ROADMAP
A15b): ``create`` raises for it.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from .base import KVStoreTimeoutError, MXNetError, getenv
from .context import resolve
from .ndarray.ndarray import NDArray
from . import resilience as _res

__all__ = ["KVStore", "KVStoreDevice", "KVStoreDist", "GradientCompression",
           "KVStoreTimeoutError", "create"]


def _key_list(key):
    return key if isinstance(key, (list, tuple)) else [key]


def _val_list(val):
    if isinstance(val, NDArray):
        return [val]
    if isinstance(val, (list, tuple)) and val and isinstance(val[0], NDArray):
        return list(val)
    raise MXNetError("invalid value type %r" % type(val))


def _group_kv(key, vals):
    """One list of values per key."""
    keys = _key_list(key)
    if len(keys) == 1:
        return keys, [_val_list(vals)]
    if not isinstance(vals, (list, tuple)) or len(vals) != len(keys):
        raise MXNetError("one value (or list) per key required")
    return keys, [_val_list(v) for v in vals]


def _fused_sum(tensors: List[torch.Tensor], device) -> torch.Tensor:
    """The sum of ``tensors`` on ``device`` (a new tensor)."""
    acc = tensors[0].detach().to(device, copy=True)
    for t in tensors[1:]:
        acc.add_(t.detach().to(device))
    return acc


class GradientCompression(object):
    """2-bit compression with error feedback (reference
    ``src/kvstore/gradient_compression.h``): ``x = g + residual`` becomes
    ``threshold`` where above it, ``-threshold`` where below minus it,
    else 0; the residual keeps what was dropped, per key."""

    def __init__(self, type="2bit", threshold=0.5):  # noqa: A002 - parity
        if type != "2bit":
            raise MXNetError("unsupported compression type %r" % type)
        if float(threshold) <= 0:
            raise MXNetError("threshold must be positive")
        self.type = type
        self.threshold = float(threshold)
        self._residuals: Dict[Any, torch.Tensor] = {}

    def compress(self, key, grad: torch.Tensor) -> torch.Tensor:
        x = grad + self._residuals.get(key, 0.0)
        t = self.threshold
        q = torch.where(x > t, t, torch.where(x < -t, -t, 0.0)).to(x.dtype)
        self._residuals[key] = x - q
        return q


class KVStore(object):
    """The in-process store (``local``); see the module docstring."""

    def __init__(self, ctx=None):
        self._ctx = resolve(ctx)
        self._store: Dict[Any, NDArray] = {}
        self._updater: Optional[Callable] = None
        self._optimizer = None
        self._compression: Optional[GradientCompression] = None

    @property
    def type(self):
        return "local"

    def init(self, key, value):
        keys, values = _group_kv(key, value)
        for k, vals in zip(keys, values):
            if k in self._store:
                raise MXNetError("key %r already initialized" % (k,))
            if len(vals) != 1:
                raise MXNetError("init requires a single value per key")
            self._store[k] = NDArray(
                vals[0].tostype("default")._data.detach().to(self._ctx,
                                                             copy=True))

    def _stored(self, k) -> NDArray:
        if k not in self._store:
            raise MXNetError("key %r not initialized" % (k,))
        return self._store[k]

    def push(self, key, value, priority=0):
        from .ndarray.sparse import RowSparseNDArray, add as _sp_add

        keys, values = _group_kv(key, value)
        for k, vals in zip(keys, values):
            stored = self._stored(k)
            if any(v.stype != "default" for v in vals):
                if not all(isinstance(v, RowSparseNDArray) for v in vals):
                    raise MXNetError("push of mixed sparse/dense values for "
                                     "key %r is not supported" % (k,))
                merged = vals[0]
                for v in vals[1:]:
                    merged = _sp_add(merged, v)
                merged = merged.as_in_context(self._ctx)
                if self._updater is not None:
                    self._updater(k, merged, stored)
                else:
                    stored._set_data(merged.todense())
                continue
            merged = self._reduce(k, vals)
            if self._updater is not None:
                self._updater(k, NDArray(merged), stored)
            else:
                stored._set_data(merged)

    def _reduce(self, k, vals) -> "torch.Tensor":
        """The sum of a key's dense values on the store's device,
        compressed when 2-bit compression is set."""
        merged = _fused_sum([v._data for v in vals], self._ctx)
        if self._compression is not None:
            merged = self._compression.compress(k, merged)
        return merged

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        if out is None:
            raise MXNetError("pull requires out=")
        keys, outs = _group_kv(key, out)
        for k, dsts in zip(keys, outs):
            src = self._stored(k)
            for d in dsts:
                if d.stype != "default":
                    raise MXNetError("pull into %s output: use "
                                     "row_sparse_pull" % d.stype)
                src.copyto(d)

    def pushpull(self, key, value, out=None, priority=0):
        self.push(key, value, priority=priority)
        self.pull(key, out=out if out is not None else value,
                  priority=priority)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """Pull only the rows ``row_ids`` of each key (one id array for
        all outputs, or one an output)."""
        from .ndarray import sparse as _sp

        if out is None or row_ids is None:
            raise MXNetError("row_sparse_pull requires out= and row_ids=")
        keys, outs = _group_kv(key, out)
        rids = row_ids if isinstance(row_ids, (list, tuple)) else [row_ids]
        if len(rids) == 1 and len(outs[0]) > 1:
            rids = rids * len(outs[0])
        for k, dsts in zip(keys, outs):
            src = self._stored(k)
            for d, rid in zip(dsts, rids):
                _sp.retain_rows_into(src, rid, d)

    # -- updater / optimizer ------------------------------------------------
    def set_updater(self, updater):
        self._updater = updater

    def set_optimizer(self, optimizer):
        from . import optimizer as opt_mod

        self._optimizer = optimizer
        self.set_updater(opt_mod.get_updater(optimizer))

    def set_gradient_compression(self, compression_params):
        params = dict(compression_params or {})
        self._compression = GradientCompression(
            type=params.get("type", "2bit"),
            threshold=params.get("threshold", 0.5))

    def save_optimizer_states(self, fname, dump_optimizer=False):
        """Write the updater's states (momenta, histories) and, with
        ``dump_optimizer``, its update counters."""
        self._need_updater()
        with open(fname, "wb") as f:
            f.write(self._updater.get_states(dump_optimizer=dump_optimizer))

    def load_optimizer_states(self, fname):
        """Restore what ``save_optimizer_states`` wrote, onto the store's
        device."""
        self._need_updater()
        with open(fname, "rb") as f:
            self._updater.set_states(f.read(), ctx=self._ctx)

    def _need_updater(self):
        if self._updater is None:
            raise MXNetError("load/save optimizer states is only supported "
                             "when an updater is set (update_on_kvstore)")

    # -- one process: the distributed surface's defaults ---------------------
    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    def barrier(self):
        pass

    def close(self):
        pass


class KVStoreDevice(KVStore):
    """``device``/``nccl``: on one card the same store as ``local``."""

    @property
    def type(self):
        return "device"


def _kvstore_timeout() -> Optional[float]:
    """MXTPU_KVSTORE_TIMEOUT: seconds a distributed push or pull waits
    for its server before ``KVStoreTimeoutError`` (default 600; <= 0
    waits for ever)."""
    val = getenv("MXTPU_KVSTORE_TIMEOUT")
    t = 600.0 if val in (None, "") else float(val)
    return t if t > 0 else None


def _wire_deadline() -> float:
    """The retry budget of a distributed push or pull: room for two
    whole waits of MXTPU_KVSTORE_TIMEOUT and the backoff."""
    t = _kvstore_timeout()
    return 0.0 if t is None else max(2.5 * t, 60.0)


class KVStoreDist(KVStoreDevice):
    """A worker of a distributed store (the reference's
    ``KVStoreDist``); see the module docstring."""

    def __init__(self, type_name="dist_sync", ctx=None):
        super().__init__(ctx)
        from . import _ps

        self._type = type_name
        self._worker = _ps.Worker.from_env()

    @property
    def type(self):
        return self._type

    @property
    def rank(self):
        return self._worker.rank

    @property
    def num_workers(self):
        return self._worker.num_workers

    @property
    def _sync(self) -> bool:
        return self._type != "dist_async"

    def _wire(self, site, fn, *args, **kwargs):
        return _res.guarded(site, fn, *args, timeout=_kvstore_timeout(),
                            _retry_deadline=_wire_deadline(), **kwargs)

    def init(self, key, value):
        keys, values = _group_kv(key, value)
        for k, vals in zip(keys, values):
            if k in self._store:
                raise MXNetError("key %r already initialized" % (k,))
            dense = vals[0].tostype("default")
            self._store[k] = NDArray(dense._data.detach().to(self._ctx,
                                                             copy=True))
            if self._worker.rank == 0:
                self._worker.init(k, dense.asnumpy())
            else:
                self._worker.register_meta(k, dense.shape, dense.dtype)
        self._worker.barrier()

    def push(self, key, value, priority=0):
        from .ndarray.sparse import RowSparseNDArray, add as _sp_add

        keys, values = _group_kv(key, value)
        for k, vals in zip(keys, values):
            self._stored(k)
            if any(v.stype != "default" for v in vals):
                if not all(isinstance(v, RowSparseNDArray) for v in vals):
                    raise MXNetError("push of mixed sparse/dense values for "
                                     "key %r is not supported" % (k,))
                merged = vals[0]
                for v in vals[1:]:
                    merged = _sp_add(merged, v)
                # rows only on the wire
                self._wire("kvstore_push", self._worker.push_rows, k,
                           merged.indices.asnumpy(), merged.data.asnumpy(),
                           sync=self._sync)
                continue
            merged = self._reduce(k, vals)
            self._wire("kvstore_push", self._worker.push, k,
                       merged.cpu().numpy(), sync=self._sync)

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        if out is None:
            raise MXNetError("pull requires out=")
        keys, outs = _group_kv(key, out)
        for k, dsts in zip(keys, outs):
            self._stored(k)
            arr = self._wire("kvstore_pull", self._worker.pull, k,
                             sync=self._sync)
            src = torch.from_numpy(arr)
            for d in dsts:
                if d.stype != "default":
                    raise MXNetError("pull into %s output: use "
                                     "row_sparse_pull" % d.stype)
                d._set_data(src.to(d._data.device))

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """Only the rows ``row_ids`` cross the wire."""
        from .ndarray import sparse as _sp

        if out is None or row_ids is None:
            raise MXNetError("row_sparse_pull requires out= and row_ids=")
        keys, outs = _group_kv(key, out)
        rids = row_ids if isinstance(row_ids, (list, tuple)) else [row_ids]
        if len(rids) == 1 and len(outs[0]) > 1:
            rids = rids * len(outs[0])
        for k, dsts in zip(keys, outs):
            self._stored(k)
            for d, rid in zip(dsts, rids):
                ids = np.asarray(rid.asnumpy() if isinstance(rid, NDArray)
                                 else rid).reshape(-1)
                rows, data = self._wire("kvstore_pull",
                                        self._worker.pull_rows, k, ids,
                                        sync=self._sync)
                _sp.set_rows_into(rows, data, d)

    def set_optimizer(self, optimizer):
        """The optimizer runs on the servers: rank 0 sends it pickled,
        then every worker waits at a barrier."""
        import pickle

        self._optimizer = optimizer
        if self._worker.rank == 0:
            self._worker.send_command("set_optimizer",
                                      pickle.dumps(optimizer))
        self._worker.barrier()

    def set_updater(self, updater):
        raise MXNetError("a distributed store runs its optimizer on the "
                         "servers: use set_optimizer")

    def barrier(self):
        self._worker.barrier()

    def send_command_to_servers(self, head, body):
        self._worker.send_command(head, body)

    def num_dead_node(self, node_id=6, timeout=None):
        """The nodes with no heartbeat within ``timeout`` seconds
        (default ``MXTPU_DEAD_TIMEOUT``); ``node_id`` is ps-lite's group
        mask: 2 servers, 4 workers, 6 both."""
        count = 0
        for nid in self._worker.num_dead_nodes(timeout):
            group = 2 if nid % 2 == 0 else 4
            if node_id & group:
                count += 1
        return count

    def close(self):
        self._worker.close()


def create(name: str = "local", ctx=None) -> KVStore:
    """A store of type ``name`` on ``ctx`` (default: the card); a
    ``dist_*`` name joins the job that the ``MXTPU_*`` variables
    describe."""
    name = (name or "local").lower()
    if name.startswith("dist"):
        return KVStoreDist(name, ctx)
    if name == "tpu":
        raise MXNetError("kvstore 'tpu' (a collective over several "
                         "devices) is not ported (ROADMAP A15b)")
    if name in ("device", "nccl"):
        return KVStoreDevice(ctx)
    if name == "local":
        return KVStore(ctx)
    raise MXNetError("unknown kvstore type %r" % name)
