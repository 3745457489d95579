"""Parameter server of the PyTorch port, behind the ``dist_*`` stores
(counterpart of ``mxtpu/_ps.py``; the wire protocol is the JAX
package's, byte for byte, so a worker of either package talks to a
scheduler and servers of the other).

Frames are length-prefixed: ``[8-byte length][optional 32-byte
HMAC-SHA256][4-byte header length][JSON header][raw array buffers]``.
The JSON holds scalars, lists, dicts and tagged tuples, bytes and numpy
arrays (``{"__nd__": i, "dtype", "shape"}``); nothing on the data path
is unpickled.  ``pickle`` is read only for the ``set_optimizer``
command, and only on a loopback socket or under ``MXTPU_PS_SECRET``
(which authenticates every frame).  Sockets bind to 127.0.0.1 when the
root URI is local; ``MXTPU_PS_BIND_ALL=1`` listens on all interfaces.

Roles (``MXTPU_ROLE``, or ``DMLC_ROLE``):

* scheduler: rendezvous, ranks, the server list, barriers, shutdown
  once every worker is done, and the dead-node monitor fed by each
  node's heartbeat (``MXTPU_DEAD_TIMEOUT``, ``num_dead_node``);
* server: holds the weights as host arrays.  In sync mode it sums the
  pushes of every worker for a key, then applies the updater once
  (with no updater the sum replaces the value); in async mode it
  applies each push.  The updater is the port's own, run on CPU
  tensors.  Sync pushes carry (worker, round), so a resent push is
  acknowledged and not summed twice;
* worker: places each key on a server (crc32 of the key), stripes an
  array of ``MXTPU_KVSTORE_BIGARRAY_BOUND`` elements or more over every
  server in flat chunks, and pushes and pulls dense values or only the
  flat spans of some rows (``push_rows``/``pull_rows``: traffic in
  proportion to the rows, not to the array).

Environment (``DMLC_*`` read too): ``MXTPU_PS_ROOT_URI``,
``MXTPU_PS_ROOT_PORT``, ``MXTPU_NUM_WORKER``, ``MXTPU_NUM_SERVER``,
``MXTPU_KVSTORE_BIGARRAY_BOUND``, ``MXTPU_PS_SECRET``,
``MXTPU_PS_BIND_ALL``, ``MXTPU_DEAD_TIMEOUT``,
and ``MXTPU_PS_HEARTBEAT_INTERVAL``.

Not ported (ROADMAP A17): server replication and failover, elastic
membership (re-ranking, rejoining workers, ``reconfig``), re-registering
with a restarted scheduler and the fleet checkpoint command.  A
setting that asks for them (``MXTPU_PS_REPLICATION=1``,
``MXTPU_CKPT_RESTORE``) raises; the ops answer with an error naming
A17.  The telemetry and tracing the JAX package ships on the wire wait
for A18.
"""
from __future__ import annotations

import hashlib
import hmac as hmac_mod
import json
import logging
import os
import pickle
import socket
import struct
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .base import (KVStoreTimeoutError, MXNetError, PSConnectError,
                   ServerDiedError)
from . import resilience as _res

__all__ = ["Scheduler", "Server", "Worker", "role_from_env",
           "run_scheduler", "run_server"]

_LEN = struct.Struct("!Q")
_HDR = struct.Struct("!I")
_DIGEST_SIZE = hashlib.sha256().digest_size
_A17 = "not ported (ROADMAP A17)"
# seconds a worker or a server keeps trying to reach the scheduler
# before ``PSConnectError``: the JAX package's 100 attempts of 0.1 s
_CONNECT_TIMEOUT = 10.0


def _env(*names, default=None):
    for n in names:
        v = os.environ.get(n)
        if v is not None:
            return v
    return default


def role_from_env() -> Optional[str]:
    return _env("MXTPU_ROLE", "DMLC_ROLE")


def _root_addr() -> Tuple[str, int]:
    host = _env("MXTPU_PS_ROOT_URI", "DMLC_PS_ROOT_URI", default="127.0.0.1")
    port = int(_env("MXTPU_PS_ROOT_PORT", "DMLC_PS_ROOT_PORT",
                    default="9091"))
    return host, port


def _num_workers() -> int:
    return int(_env("MXTPU_NUM_WORKER", "DMLC_NUM_WORKER", default="1"))


def _num_servers() -> int:
    return int(_env("MXTPU_NUM_SERVER", "DMLC_NUM_SERVER", default="1"))


def _bigarray_bound() -> int:
    return int(_env("MXTPU_KVSTORE_BIGARRAY_BOUND",
                    "MXNET_KVSTORE_BIGARRAY_BOUND", default="1000000"))


def _secret() -> Optional[bytes]:
    s = _env("MXTPU_PS_SECRET", "DMLC_PS_SECRET")
    return s.encode() if s else None


def _bind_host() -> str:
    """Loopback when the root URI is local, all interfaces on request
    or when the root is another host."""
    if _env("MXTPU_PS_BIND_ALL", "DMLC_PS_BIND_ALL", default="0") == "1":
        return "0.0.0.0"
    if _root_addr()[0] in ("127.0.0.1", "localhost", "::1"):
        return "127.0.0.1"
    return "0.0.0.0"


def _dead_timeout() -> float:
    """Seconds of heartbeat silence after which the scheduler declares
    a node dead."""
    return float(_env("MXTPU_DEAD_TIMEOUT", "DMLC_DEAD_TIMEOUT",
                      default="60"))


def _heartbeat_interval() -> float:
    return float(_env("MXTPU_PS_HEARTBEAT_INTERVAL",
                      "DMLC_PS_HEARTBEAT_INTERVAL", default="1.0"))


def _check_not_elastic():
    """Raise where a setting asks for what waits for A17."""
    if _env("MXTPU_PS_REPLICATION", "DMLC_PS_REPLICATION",
            default="0") == "1":
        raise MXNetError("MXTPU_PS_REPLICATION=1: server replication and "
                         "failover are %s" % _A17)
    if os.environ.get("MXTPU_CKPT_RESTORE"):
        raise MXNetError("MXTPU_CKPT_RESTORE: restoring the servers from "
                         "a fleet checkpoint is %s" % _A17)


# ---------------------------------------------------------------------------
# Wire format
# ---------------------------------------------------------------------------

def _encode(obj) -> bytes:
    """The header-and-buffers payload of ``obj``: JSON-safe scalars,
    lists and str-keyed dicts, tagged tuples, bytes, and numpy arrays
    (their raw buffers follow the header)."""
    bufs: List[bytes] = []

    def enc(o):
        if o is None or isinstance(o, (bool, int, float, str)):
            return o
        if isinstance(o, (np.integer, np.floating, np.bool_)):
            return o.item()
        if isinstance(o, np.ndarray):
            a = np.ascontiguousarray(o)
            # a custom dtype (bfloat16) reads '<V2' in .str; its name
            # round-trips
            dt = a.dtype.name if a.dtype.kind == "V" else a.dtype.str
            try:
                if np.dtype(dt) != a.dtype:
                    raise TypeError
            except TypeError:
                raise TypeError("unsupported array dtype %r" % (a.dtype,))
            bufs.append(a.tobytes())
            return {"__nd__": len(bufs) - 1, "dtype": dt,
                    "shape": list(a.shape)}
        if isinstance(o, (bytes, bytearray, memoryview)):
            bufs.append(bytes(o))
            return {"__bytes__": len(bufs) - 1}
        if isinstance(o, tuple):
            return {"__tuple__": [enc(x) for x in o]}
        if isinstance(o, list):
            return [enc(x) for x in o]
        if isinstance(o, dict):
            out = {}
            for k, v in o.items():
                if not isinstance(k, str):
                    raise TypeError("non-str dict key %r" % (k,))
                if k.startswith("__") and k.endswith("__"):
                    raise TypeError("reserved dict key %r" % (k,))
                out[k] = enc(v)
            return out
        raise TypeError("unsupported wire type %s" % type(o).__name__)

    header = json.dumps(
        {"msg": enc(obj), "bufs": [len(b) for b in bufs]},
        separators=(",", ":")).encode()
    return _HDR.pack(len(header)) + header + b"".join(bufs)


def _decode(payload: bytes):
    (hlen,) = _HDR.unpack_from(payload)
    header = json.loads(payload[_HDR.size:_HDR.size + hlen])
    bufs: List[bytes] = []
    off = _HDR.size + hlen
    for n in header["bufs"]:
        bufs.append(payload[off:off + n])
        off += n

    def dec(o):
        if isinstance(o, dict):
            if "__nd__" in o:
                return np.frombuffer(
                    bufs[o["__nd__"]],
                    dtype=np.dtype(o["dtype"])).reshape(o["shape"]).copy()
            if "__bytes__" in o:
                return bufs[o["__bytes__"]]
            if "__tuple__" in o:
                return tuple(dec(x) for x in o["__tuple__"])
            return {k: dec(v) for k, v in o.items()}
        if isinstance(o, list):
            return [dec(x) for x in o]
        return o

    return dec(header["msg"])


def _send_msg(sock: socket.socket, obj) -> None:
    payload = _encode(obj)
    secret = _secret()
    if secret is not None:
        mac = hmac_mod.new(secret, payload, hashlib.sha256).digest()
        payload = mac + payload
    sock.sendall(_LEN.pack(len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf.extend(chunk)
    return bytes(buf)


def _recv_msg(sock: socket.socket):
    (n,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    payload = _recv_exact(sock, n)
    secret = _secret()
    if secret is not None:
        if n < _DIGEST_SIZE:
            raise ConnectionError("frame too short for HMAC")
        mac, payload = payload[:_DIGEST_SIZE], payload[_DIGEST_SIZE:]
        want = hmac_mod.new(secret, payload, hashlib.sha256).digest()
        if not hmac_mod.compare_digest(mac, want):
            raise ConnectionError("HMAC verification failed")
    return _decode(payload)


def _span_index(starts: np.ndarray, stops: np.ndarray) -> np.ndarray:
    """The flat positions of the spans [starts[i], stops[i]), in order
    (one ``np.arange`` a span, without a Python loop)."""
    lens = stops - starts
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    offs = np.cumsum(lens) - lens
    return np.repeat(starts - offs, lens) + np.arange(total, dtype=np.int64)


def _row_spans(rows: np.ndarray, width: int, lo: int, hi: int):
    """(mask, spans, cols): the rows whose flat extent
    [r * width, (r + 1) * width) meets the chunk [lo, hi), the (n, 2)
    int64 spans of that overlap relative to the chunk, and the overlap's
    (start, stop) columns within each such row."""
    a = rows * width
    ia = np.maximum(a, lo)
    ib = np.minimum(a + width, hi)
    mask = ia < ib
    ia, ib, a = ia[mask], ib[mask], a[mask]
    spans = np.stack([ia - lo, ib - lo], axis=1).astype(np.int64)
    return mask, spans, (ia - a, ib - a)


class _Client(object):
    """A persistent request/response connection (thread-safe)."""

    def __init__(self, addr: Tuple[str, int], retries: int = 100,
                 deadline: Optional[float] = None):
        self._addr = tuple(addr)
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()
        self._connect(retries, deadline=deadline)

    def _connect(self, retries: int = 100,
                 deadline: Optional[float] = None):
        """Connect with backoff within ``deadline`` seconds (default
        ``retries`` x 0.1 s); ``PSConnectError`` when that runs out."""
        budget = deadline if deadline is not None else max(0.1,
                                                           retries * 0.1)

        def attempt():
            sock = socket.create_connection(self._addr, timeout=budget)
            sock.settimeout(None)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            return sock

        try:
            self._sock = _res.run_with_retry(
                "ps_connect", attempt, retry_on=(OSError,),
                max_retries=1_000_000, deadline=budget)
        except _res.RetryExhausted as e:
            self._sock = None
            raise PSConnectError("cannot reach %s within %.1fs: %s"
                                 % (self._addr, budget, e.__cause__)) \
                from e

    def request(self, obj, timeout: Optional[float] = None):
        """One exchange.  ``timeout`` bounds the send and the wait for
        the reply; on expiry the connection is dropped (a late reply
        would desynchronise it) and ``KVStoreTimeoutError`` raised."""
        with self._lock:
            if self._sock is None:
                self._connect(retries=20)
            try:
                self._sock.settimeout(timeout)
                _send_msg(self._sock, obj)
                return _recv_msg(self._sock)
            except socket.timeout as e:
                self._drop()
                op = obj.get("op") if isinstance(obj, dict) else "?"
                raise KVStoreTimeoutError(
                    "no server response within %.1fs for op %r (set "
                    "MXTPU_KVSTORE_TIMEOUT to adjust; <=0 disables)"
                    % (timeout, op)) from e
            except OSError:
                self._drop()
                raise
            finally:
                if self._sock is not None:
                    try:
                        self._sock.settimeout(None)
                    except OSError:
                        pass

    def _drop(self):
        try:
            self._sock.close()
        except OSError:
            pass
        self._sock = None

    def close(self):
        try:
            if self._sock is not None:
                self._sock.close()
        except OSError:
            pass


def _start_heartbeat(node_id: int, stop: threading.Event
                     ) -> threading.Thread:
    """A daemon thread that beats the scheduler every
    ``MXTPU_PS_HEARTBEAT_INTERVAL`` seconds on a connection of its own
    (the main one is held through a barrier), until ``stop`` is set or
    the scheduler is gone (shutdown)."""
    interval = _heartbeat_interval()

    def loop():
        try:
            client = _Client(_root_addr(), deadline=max(1.0, interval))
        except ConnectionError:
            return
        try:
            while not stop.is_set():
                client.request({"op": "heartbeat", "node_id": node_id})
                stop.wait(interval)
        except (ConnectionError, EOFError, OSError):
            pass
        finally:
            client.close()

    t = threading.Thread(target=loop, daemon=True, name="ps-heartbeat")
    t.start()
    return t


# ---------------------------------------------------------------------------
# Scheduler
# ---------------------------------------------------------------------------

class Scheduler(object):
    """Rendezvous: ranks, the server list, barriers and shutdown (the
    dmlc-tracker's role), and the dead-node monitor.  Node ids follow
    ps-lite: the scheduler 1, server rank r 8 + 2r, worker registration
    r 9 + 2r.  ``sock`` is a socket already bound (and listening) to
    take instead of binding ``port`` (default ``MXTPU_PS_ROOT_PORT``;
    0 picks a free one, read back from ``_port``)."""

    def __init__(self, port: Optional[int] = None,
                 sock: Optional[socket.socket] = None):
        _check_not_elastic()
        self._nw = _num_workers()
        self._ns = _num_servers()
        if sock is None:
            sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            sock.bind((_bind_host(),
                       port if port is not None else _root_addr()[1]))
        sock.listen(128)
        self._sock = sock
        self._port = sock.getsockname()[1]
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._servers: Dict[int, Tuple[str, int]] = {}
        self._workers: List[int] = []  # worker node ids, in rank order
        self._dead: set = set()
        self._done_nodes: set = set()
        self._barrier_waiters: set = set()
        self._barrier_gen = 0
        self._dead_timeout = _dead_timeout()
        self._threads: List[threading.Thread] = []
        self._conns: List[socket.socket] = []
        self._last_beat: Dict[int, float] = {}
        self._monitor: Optional[threading.Thread] = None

    def run(self):
        self._monitor = threading.Thread(target=self._monitor_loop,
                                         daemon=True, name="ps-monitor")
        self._monitor.start()
        while True:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                break
            if self._stop.is_set():
                conn.close()
                break
            self._conns.append(conn)
            t = threading.Thread(target=self._handle, args=(conn,),
                                 daemon=True, name="ps-sched-conn")
            t.start()
            self._threads.append(t)
        for t in self._threads:
            t.join(timeout=5)
        self._sock.close()
        self._monitor.join(timeout=5)

    def _handle(self, conn: socket.socket):
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            while True:
                msg = _recv_msg(conn)
                op = msg["op"]
                if op == "register":
                    _send_msg(conn, self._register(msg))
                elif op == "reregister":
                    _send_msg(conn, self._reregister(msg))
                elif op == "heartbeat":
                    with self._cv:
                        nid = int(msg["node_id"])
                        declared = nid in self._dead
                        if not declared:
                            self._last_beat[nid] = time.time()
                    _send_msg(conn, {"ok": True,
                                     "declared_dead": declared})
                elif op == "dead_nodes":
                    timeout = float(msg.get("timeout",
                                            self._dead_timeout))
                    now = time.time()
                    with self._cv:
                        stale = set(nid for nid, ts in
                                    self._last_beat.items()
                                    if now - ts > timeout)
                        dead = sorted(stale | self._dead)
                    _send_msg(conn, {"dead": dead})
                elif op == "group_info":
                    with self._cv:
                        _send_msg(conn, self._group_info_locked())
                elif op == "barrier":
                    _send_msg(conn, self._barrier(msg))
                elif op == "done":
                    with self._cv:
                        nid = int(msg.get("node_id", -1))
                        self._last_beat.pop(nid, None)
                        if nid in self._workers:
                            self._done_nodes.add(nid)
                        self._barrier_waiters.discard(nid)
                        self._cv.notify_all()
                    _send_msg(conn, {"ok": True})
                    if self._maybe_shutdown():
                        break
                elif op in ("ckpt", "telemetry"):
                    _send_msg(conn, {"error": "op %r is not ported "
                                     "(ROADMAP A17/A18)" % op})
                else:
                    _send_msg(conn, {"error": "bad op %r" % op})
        except (ConnectionError, EOFError, OSError):
            pass
        finally:
            conn.close()
            try:
                self._conns.remove(conn)
            except ValueError:
                pass

    def _group_info_locked(self):
        return {"gen": 0, "num_workers": len(self._workers),
                "ranks": [[nid, r] for r, nid in enumerate(self._workers)],
                "dead": sorted(self._dead)}

    def _register(self, msg):
        with self._cv:
            if msg["role"] == "server":
                if len(self._servers) >= self._ns:
                    return {"error": "all %d servers registered: a "
                            "replacement server is %s" % (self._ns, _A17)}
                rank = len(self._servers)
                self._servers[rank] = tuple(msg["addr"])
                node_id = 8 + 2 * rank
                self._cv.notify_all()
            else:
                if len(self._workers) >= self._nw:
                    return {"error": "all %d workers registered: a "
                            "rejoining worker is %s" % (self._nw, _A17)}
                node_id = 9 + 2 * len(self._workers)
                self._workers.append(node_id)
                rank = len(self._workers) - 1
            self._last_beat[node_id] = time.time()
            while len(self._servers) < self._ns and \
                    not self._stop.is_set():
                self._cv.wait()
            servers = [self._servers[i] for i in range(len(self._servers))]
        return {"rank": rank, "servers": servers,
                "num_workers": self._nw, "num_servers": self._ns,
                "node_id": node_id, "gen": 0, "rejoin": False,
                "live_workers": len(self._workers)}

    def _reregister(self, msg):
        """A known node reporting its identity (the JAX package's
        heartbeat does so when it connects) is acknowledged; rebuilding
        membership after a scheduler restart is A17."""
        nid = int(msg["node_id"])
        with self._cv:
            known = nid in self._workers or any(
                8 + 2 * r == nid for r in self._servers)
            if not known or nid in self._dead:
                return {"error": "node %d is unknown to this scheduler: "
                        "re-registering after a restart is %s"
                        % (nid, _A17)}
            self._last_beat[nid] = time.time()
            return {"ok": True, "gen": 0, "num_workers": len(self._workers)}

    def _barrier(self, msg):
        with self._cv:
            nid = msg["node_id"]
            gen = self._barrier_gen
            self._barrier_waiters.add(nid)
            if len(self._barrier_waiters) >= self._nw:
                self._barrier_waiters.clear()
                self._barrier_gen += 1
                self._cv.notify_all()
            else:
                while gen == self._barrier_gen and not self._stop.is_set():
                    self._cv.wait()
            return {"ok": True, "gen": 0, "num_workers": len(self._workers),
                    "rank": self._workers.index(nid)
                    if nid in self._workers else None}

    def _monitor_loop(self):
        """Declare nodes dead after ``MXTPU_DEAD_TIMEOUT`` seconds of
        heartbeat silence (``num_dead_node`` reports them); the group
        is not re-formed around them (A17)."""
        interval = min(1.0, max(0.05, self._dead_timeout / 4.0))
        while not self._stop.wait(interval):
            now = time.time()
            with self._cv:
                for nid, ts in list(self._last_beat.items()):
                    if now - ts > self._dead_timeout:
                        self._last_beat.pop(nid)
                        self._dead.add(nid)
                        logging.getLogger(__name__).error(
                            "scheduler: node %d sent no heartbeat for "
                            "%.0fs and is declared dead", nid,
                            self._dead_timeout)

    def _maybe_shutdown(self) -> bool:
        """Once every worker is done: shut the servers down and stop."""
        with self._cv:
            if len(self._done_nodes) < self._nw:
                return False
            servers = sorted(self._servers.items())
            for r, _ in servers:
                self._last_beat.pop(8 + 2 * r, None)
        for rank, addr in servers:
            if 8 + 2 * rank in self._dead:
                continue
            try:
                c = _Client(addr, retries=3)
                c.request({"op": "shutdown"})
                c.close()
            except (ConnectionError, OSError):
                pass
        with self._cv:
            self._stop.set()
            self._cv.notify_all()
        try:  # wake our own accept()
            socket.create_connection(("127.0.0.1", self._port),
                                     timeout=1).close()
        except OSError:
            pass
        return True


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------

class Server(object):
    """Holds the weights (the reference's ``KVStoreDistServer``): sync
    pushes of every worker sum, then the updater runs once; async
    pushes apply one by one.  ``controller(head, body)`` receives the
    commands other than ``set_optimizer``."""

    def __init__(self, controller=None):
        _check_not_elastic()
        self._controller = controller
        self._nw = _num_workers()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        bind_host = _bind_host()
        self._local_only = bind_host == "127.0.0.1"
        self._sock.bind((bind_host, 0))
        self._sock.listen(128)
        self._addr = (socket.gethostbyname(socket.gethostname())
                      if _root_addr()[0] not in ("127.0.0.1", "localhost")
                      else "127.0.0.1", self._sock.getsockname()[1])
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._store: Dict[Any, np.ndarray] = {}
        self._versions: Dict[Any, int] = {}
        # key -> (sum so far, the workers it holds)
        self._pending: Dict[Any, Tuple[np.ndarray, set]] = {}
        self._errors: Dict[Any, str] = {}
        self._updater = None
        self._shutdown = threading.Event()
        self._conns: List[socket.socket] = []
        self._sched = _Client(_root_addr(), deadline=_CONNECT_TIMEOUT)
        info = self._sched.request({"op": "register", "role": "server",
                                    "addr": self._addr})
        if info.get("error"):
            self._sock.close()
            self._sched.close()
            raise MXNetError("server registration refused: %s"
                             % info["error"])
        self.rank = info["rank"]
        self.node_id = info.get("node_id", 8 + 2 * self.rank)
        self.heartbeat = _start_heartbeat(self.node_id, self._shutdown)

    def run(self):
        while not self._shutdown.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                break
            self._conns.append(conn)
            threading.Thread(target=self._handle, args=(conn,),
                             daemon=True, name="ps-server-conn").start()
        self._sock.close()
        self._sched.close()
        self.heartbeat.join(timeout=5)

    def _handle(self, conn: socket.socket):
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            while True:
                msg = _recv_msg(conn)
                op = msg["op"]
                if op == "init":
                    with self._cv:
                        self._store[msg["key"]] = np.array(msg["value"])
                        self._versions[msg["key"]] = 0
                    _send_msg(conn, {"ok": True})
                elif op == "push":
                    _send_msg(conn, self._push(msg))
                elif op == "pull":
                    _send_msg(conn, self._pull(msg))
                elif op == "pull_rows":
                    _send_msg(conn, self._pull_rows(msg))
                elif op == "push_rows":
                    _send_msg(conn, self._push_rows(msg))
                elif op == "version":
                    with self._lock:
                        _send_msg(conn, {"version":
                                         self._versions.get(msg["key"],
                                                            0)})
                elif op == "command":
                    _send_msg(conn, self._command(msg))
                elif op in ("reconfig", "join", "replicate", "promote"):
                    _send_msg(conn, {"error": "op %r is %s" % (op, _A17)})
                elif op == "shutdown":
                    with self._cv:
                        self._shutdown.set()
                        self._cv.notify_all()
                    _send_msg(conn, {"ok": True})
                    try:  # wake accept()
                        socket.create_connection(
                            ("127.0.0.1", self._addr[1]), timeout=1).close()
                    except OSError:
                        pass
                    break
                else:
                    _send_msg(conn, {"error": "bad op %r" % op})
        except (ConnectionError, EOFError, OSError):
            pass
        finally:
            conn.close()
            try:
                self._conns.remove(conn)
            except ValueError:
                pass

    def _apply(self, key, merged: np.ndarray):
        """The updater on CPU tensors when one is set, else the merged
        value replaces the stored one."""
        if self._updater is not None:
            import torch

            from .ndarray.ndarray import NDArray

            recv = NDArray(torch.from_numpy(np.array(merged)))
            stored = NDArray(torch.from_numpy(np.array(self._store[key])))
            self._updater(key, recv, stored)
            self._store[key] = stored.asnumpy()
        else:
            self._store[key] = merged
        self._versions[key] = self._versions.get(key, 0) + 1

    def _apply_safe(self, key, merged: np.ndarray):
        """Apply; if the updater fails, the version still advances and
        the error is kept, so that every waiting worker sees it rather
        than hang.  Called with the lock held."""
        try:
            self._apply(key, merged)
        except Exception as e:
            self._errors[key] = "server updater failed for %r: %r" % (key, e)
            self._versions[key] = self._versions.get(key, 0) + 1
        self._cv.notify_all()

    def _push(self, msg):
        key, value, sync = msg["key"], np.array(msg["value"]), msg["sync"]
        wid = msg["worker"]
        rnd = msg.get("round")
        with self._cv:
            if key not in self._store:
                return {"error": "key %r not initialized on server" % (key,)}
            if not sync:
                self._apply_safe(key, value)
                return {"version": self._versions[key],
                        "error": self._errors.get(key)}
            version = self._versions.get(key, 0)
            target = version + 1
            # a resent push of a round already applied, or already
            # counted, is acknowledged and not summed again
            if rnd is not None and rnd <= version:
                return {"version": version, "duplicate": True,
                        "error": self._errors.get(key)}
            if rnd is not None and rnd > target:
                return {"error": "push of round %d arrived at version %d "
                                 "(target %d)" % (rnd, version, target),
                        "round_gap": True}
            acc, contributors = self._pending.get(key, (None, set()))
            if wid in contributors:
                return {"version": target, "duplicate": True,
                        "error": self._errors.get(key)}
            acc = value if acc is None else acc + value
            contributors.add(wid)
            if len(contributors) >= self._nw:
                self._pending.pop(key, None)
                self._apply_safe(key, acc)
            else:
                self._pending[key] = (acc, contributors)
            return {"version": target, "error": self._errors.get(key)}

    def _wait_version_locked(self, key, min_version):
        """Wait for ``key`` to reach ``min_version``; an error reply
        when it failed or the server shut down first."""
        while (key not in self._store
               or self._versions.get(key, 0) < min_version) \
                and not self._shutdown.is_set() and key not in self._errors:
            self._cv.wait()
        if key in self._errors:
            return {"value": None, "error": self._errors[key]}
        if key not in self._store or \
                self._versions.get(key, 0) < min_version:
            return {"value": None,
                    "error": "server shut down before %r reached "
                             "version %d" % (key, min_version)}
        return None

    def _pull(self, msg):
        key = msg["key"]
        with self._cv:
            err = self._wait_version_locked(key, msg.get("min_version", 0))
            if err is not None:
                return err
            return {"value": self._store.get(key),
                    "version": self._versions.get(key, 0)}

    def _push_rows(self, msg):
        """A push of some flat spans of a key's chunk: expanded to a
        dense delta of the chunk, which takes the ordinary push path
        (the stored value stays dense, as in the JAX package)."""
        key = msg["key"]
        spans = np.asarray(msg["spans"], dtype=np.int64).reshape(-1, 2)
        with self._lock:
            ref = self._store.get(key)
        if ref is None:
            return {"error": "key %r not initialized on server" % (key,)}
        dense = np.zeros_like(ref)
        dense[_span_index(spans[:, 0], spans[:, 1])] = \
            np.asarray(msg["value"])
        return self._push({"key": key, "value": dense, "sync": msg["sync"],
                           "worker": msg["worker"],
                           "round": msg.get("round")})

    def _pull_rows(self, msg):
        """Only the requested flat spans of the key's chunk."""
        key = msg["key"]
        spans = np.asarray(msg["spans"], dtype=np.int64).reshape(-1, 2)
        with self._cv:
            err = self._wait_version_locked(key, msg.get("min_version", 0))
            if err is not None:
                return err
            value = self._store[key][_span_index(spans[:, 0], spans[:, 1])]
            return {"value": value, "version": self._versions.get(key, 0)}

    def _command(self, msg):
        head, body = msg["head"], msg["body"]
        if head == "set_optimizer":
            # the one pickle.loads on the wire, and only on a trusted
            # transport: loopback, or frames checked by HMAC
            if not (self._local_only or _secret() is not None):
                return {"error":
                        "refusing pickled set_optimizer on a non-loopback "
                        "socket without MXTPU_PS_SECRET"}
            from . import optimizer as opt_mod

            optimizer = pickle.loads(body)
            with self._lock:
                self._updater = opt_mod.get_updater(optimizer)
        elif head == "mxtpu_ckpt":
            return {"error": "the fleet checkpoint command is %s" % _A17}
        elif self._controller is not None:
            try:
                self._controller(head, body)
            except Exception as e:  # a controller's fault must not kill
                return {"error": "controller failed: %s" % e}
        return {"ok": True}


# ---------------------------------------------------------------------------
# Worker
# ---------------------------------------------------------------------------

class Worker(object):
    """The client side: places keys on the servers and tracks each
    (sub)key's push round, so that a sync pull waits for the whole
    round (the reference's ``ps::KVWorker`` use in ``kvstore_dist.h``)."""

    _singleton = None

    @classmethod
    def from_env(cls) -> "Worker":
        if cls._singleton is None:
            cls._singleton = cls()
        return cls._singleton

    def __init__(self):
        _check_not_elastic()
        self._sched = _Client(_root_addr(), deadline=_CONNECT_TIMEOUT)
        info = self._sched.request({"op": "register", "role": "worker"})
        if info.get("error"):
            self._sched.close()
            raise MXNetError("worker registration refused: %s"
                             % info["error"])
        self.rank = info["rank"]
        self.num_workers = info["num_workers"]
        self._server_addrs = info["servers"]
        self._servers: List[Optional[_Client]] = \
            [None] * len(self._server_addrs)
        self._last_version: Dict[Any, int] = {}
        self._meta_shape: Dict[Any, Tuple] = {}
        self._bigarray = _bigarray_bound()
        self.node_id = info.get("node_id", 9 + 2 * self.rank)
        self._closed = threading.Event()
        self.heartbeat = _start_heartbeat(self.node_id, self._closed)

    def num_dead_nodes(self, timeout: Optional[float] = None):
        """Ids of the nodes with no heartbeat within ``timeout`` seconds
        (default ``MXTPU_DEAD_TIMEOUT``) or declared dead."""
        rep = self._sched.request(
            {"op": "dead_nodes",
             "timeout": _dead_timeout() if timeout is None else timeout})
        return list(rep.get("dead", []))

    def _server_request(self, sidx: int, msg, timeout=None):
        """A request to server ``sidx``.  A server that refuses a new
        connection is dead: ``ServerDiedError`` (failover to a replica
        is A17); another transport error propagates, for the retry
        layer to reconnect."""
        try:
            c = self._servers[sidx]
            if c is None:
                c = self._servers[sidx] = _Client(
                    tuple(self._server_addrs[sidx]))
            return c.request(msg, timeout=timeout)
        except KVStoreTimeoutError:
            raise
        except (ConnectionError, OSError) as err:
            try:
                socket.create_connection(tuple(self._server_addrs[sidx]),
                                         timeout=0.2).close()
            except OSError:
                raise ServerDiedError(
                    "server rank %d at %s is gone (failover is %s)"
                    % (sidx, tuple(self._server_addrs[sidx]), _A17)) \
                    from err
            raise

    def register_meta(self, key, shape, dtype):
        """Record a key's shape and dtype without initialising it on the
        servers (rank 0 does that)."""
        self._meta_shape[key] = (tuple(shape), np.dtype(dtype))

    def _chunks(self, key, size: int):
        """[(server, subkey, lo, hi)]: the whole flat array on one
        server, or striped over all of them from the bigarray bound."""
        ns = len(self._servers)
        home = zlib.crc32(str(key).encode()) % ns
        if size < self._bigarray or ns == 1:
            return [(home, (key, 0), 0, size)]
        out = []
        step = (size + ns - 1) // ns
        for i in range(ns):
            lo, hi = i * step, min((i + 1) * step, size)
            if lo < hi:
                out.append(((home + i) % ns, (key, i), lo, hi))
        return out

    def _round(self, subkey) -> int:
        return self._last_version.get(subkey, 0) + 1

    def _check_push(self, rep, what, key):
        if rep.get("error"):
            raise ConnectionError("%s of %r failed: %s"
                                  % (what, key, rep["error"]))

    def init(self, key, value: np.ndarray):
        flat = np.ascontiguousarray(value).reshape(-1)
        self._meta_shape[key] = (value.shape, value.dtype)
        for sidx, subkey, lo, hi in self._chunks(key, flat.size):
            self._server_request(sidx, {"op": "init", "key": subkey,
                                        "value": flat[lo:hi]})

    def push(self, key, value: np.ndarray, sync: bool = True,
             timeout: Optional[float] = None):
        flat = np.ascontiguousarray(value).reshape(-1)
        self._meta_shape.setdefault(key, (value.shape, value.dtype))
        for sidx, subkey, lo, hi in self._chunks(key, flat.size):
            msg = {"op": "push", "key": subkey, "value": flat[lo:hi],
                   "sync": sync, "worker": self.node_id}
            if sync:
                msg["round"] = self._round(subkey)
            rep = self._server_request(sidx, msg, timeout=timeout)
            self._check_push(rep, "push", key)
            self._last_version[subkey] = rep["version"]

    def pull(self, key, sync: bool = True,
             timeout: Optional[float] = None) -> np.ndarray:
        shape, dtype = self._meta_shape[key]
        size = int(np.prod(shape, dtype=np.int64)) if shape else 1
        flat = np.empty(size, dtype=dtype)
        for sidx, subkey, lo, hi in self._chunks(key, size):
            rep = self._server_request(
                sidx, {"op": "pull", "key": subkey,
                       "min_version":
                       self._last_version.get(subkey, 0) if sync else 0},
                timeout=timeout)
            if rep.get("value") is None:
                raise ConnectionError(
                    "pull of %r failed: %s" % (key, rep.get(
                        "error", "server shut down while waiting")))
            flat[lo:hi] = rep["value"]
        return flat.reshape(shape)

    def pull_rows(self, key, row_ids, sync: bool = True,
                  timeout: Optional[float] = None):
        """(rows, values): only the rows ``row_ids`` of ``key`` (unique,
        sorted, in range); each server sends the flat spans of its
        chunk that those rows cover."""
        shape, dtype = self._meta_shape[key]
        if len(shape) < 1:
            raise ValueError("pull_rows needs a >=1-D key")
        width = int(np.prod(shape[1:], dtype=np.int64)) if len(shape) > 1 \
            else 1
        rows = np.unique(np.asarray(row_ids, dtype=np.int64))
        rows = rows[(rows >= 0) & (rows < shape[0])]
        out = np.zeros((len(rows), width), dtype=dtype)
        size = int(np.prod(shape, dtype=np.int64))
        for sidx, subkey, lo, hi in self._chunks(key, size):
            mask, spans, (ca, cb) = _row_spans(rows, width, lo, hi)
            if not len(spans):
                continue
            rep = self._server_request(
                sidx, {"op": "pull_rows", "key": subkey, "spans": spans,
                       "min_version":
                       self._last_version.get(subkey, 0) if sync else 0},
                timeout=timeout)
            if rep.get("value") is None:
                raise ConnectionError(
                    "pull_rows of %r failed: %s" % (key, rep.get(
                        "error", "server shut down while waiting")))
            base = np.nonzero(mask)[0] * width
            out.reshape(-1)[_span_index(base + ca, base + cb)] = \
                np.asarray(rep["value"])
        return rows, out.reshape((len(rows),) + tuple(shape[1:]))

    def push_rows(self, key, rows: np.ndarray, data: np.ndarray,
                  sync: bool = True, timeout: Optional[float] = None):
        """Push only ``rows`` of ``key``: traffic in proportion to the
        rows."""
        shape, dtype = self._meta_shape[key]
        width = int(np.prod(shape[1:], dtype=np.int64)) if len(shape) > 1 \
            else 1
        order = np.argsort(rows)
        rows = np.asarray(rows, np.int64)[order]
        flat = np.ascontiguousarray(data, dtype=dtype).reshape(
            -1, width)[order]
        size = int(np.prod(shape, dtype=np.int64))
        for sidx, subkey, lo, hi in self._chunks(key, size):
            mask, spans, (ca, cb) = _row_spans(rows, width, lo, hi)
            base = np.nonzero(mask)[0] * width
            value = flat.reshape(-1)[_span_index(base + ca, base + cb)]
            msg = {"op": "push_rows", "key": subkey, "spans": spans,
                   "value": value, "sync": sync, "worker": self.node_id}
            if sync:
                msg["round"] = self._round(subkey)
            rep = self._server_request(sidx, msg, timeout=timeout)
            self._check_push(rep, "push_rows", key)
            self._last_version[subkey] = rep["version"]

    def barrier(self):
        rep = self._sched.request({"op": "barrier",
                                   "node_id": self.node_id})
        if isinstance(rep, dict) and rep.get("error"):
            raise ServerDiedError(rep["error"])

    def send_command(self, head: str, body):
        for sidx in range(len(self._servers)):
            rep = self._server_request(sidx, {"op": "command",
                                              "head": head, "body": body})
            if rep.get("error"):
                raise ConnectionError("command %r rejected: %s"
                                      % (head, rep["error"]))

    def close(self):
        self._closed.set()
        try:
            self._sched.request({"op": "done", "node_id": self.node_id})
        except ConnectionError:
            pass
        for s in self._servers:
            if s is not None:
                s.close()
        self._sched.close()
        self.heartbeat.join(timeout=5)
        if Worker._singleton is self:
            Worker._singleton = None


# ---------------------------------------------------------------------------
# Role entry points (the reference's python/mxnet/kvstore_server.py)
# ---------------------------------------------------------------------------

def run_scheduler():
    """The scheduler of a launched job; the launcher may hand it its
    socket, bound and listening, as the descriptor
    ``MXTPU_PS_SCHEDULER_FD``."""
    fd = os.environ.get("MXTPU_PS_SCHEDULER_FD")
    sock = socket.socket(fileno=int(fd)) if fd else None
    Scheduler(sock=sock).run()


def run_server(controller=None):
    Server(controller=controller).run()
