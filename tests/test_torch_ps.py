"""The PyTorch port's parameter server (`mxtpu_torch/_ps.py`) against
the JAX package's (`mxtpu/_ps.py`), on the CPU, every role a thread of
the test process.

* Wire: the two codecs write the same bytes for the same frames (dense
  pushes, rows-only pushes, commands, nested values), with and without
  `MXTPU_PS_SECRET`'s HMAC, and each decodes the other's.  The two
  `Worker`s send the same frames for the same calls, with a key striped
  over two servers (`MXTPU_KVSTORE_BIGARRAY_BOUND`), and assemble the
  same rows from the same replies.
* Cross-package traffic: two port workers against the reference's
  scheduler and server, and two reference workers against the port's,
  push and pull dense values and rows in sync and async mode (no
  optimizer: a pickle does not cross packages).  Sync rounds sum; async
  pushes replace.
* Parity: each package's scheduler, two servers and two workers take
  the same gradients with an SGD (momentum, weight decay) and an
  AdaGrad optimizer set on the servers, in `dist_sync` and, pushes in a
  fixed order, `dist_async`; the pulled weights agree within 1e-6.

Every role is closed and every thread the test started is joined.  A
scenario runs under a watchdog (`_within`), so a wedged role fails the
test rather than hang it.
"""
import contextlib
import pickle
import threading
import time

import numpy as np
import pytest

import mxtpu as jmx
from mxtpu import _ps as J
import mxtpu_torch as tmx
from mxtpu_torch import _ps as T
import torch

torch.set_num_threads(1)

PARITY = dict(rtol=0, atol=1e-6)


def _within(seconds, fn):
    """fn() in a thread, failing if it takes longer than ``seconds``."""
    out = {}

    def body():
        try:
            out["value"] = fn()
        except BaseException as e:  # re-raised in the test's thread
            out["error"] = e

    t = threading.Thread(target=body, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), "scenario still running after %ss" % seconds
    if "error" in out:
        raise out["error"]
    return out.get("value")


def join_new_threads(before, seconds=20):
    """Join every thread started since ``before``, the set of threads
    then; fail if one is alive after ``seconds``.  Threads may start
    while this waits (a server accepts its own wake-up connection), so
    it looks again until none is left."""
    deadline = time.monotonic() + seconds
    while True:
        new = [t for t in threading.enumerate() if t not in before]
        if not new:
            return
        assert time.monotonic() < deadline, \
            "threads still alive: %s" % [t.name for t in new]
        for t in new:
            if t.ident is None:  # started, not yet running
                time.sleep(0.01)
            else:
                t.join(max(0.0, deadline - time.monotonic()))


@pytest.fixture
def ps_env(monkeypatch):
    monkeypatch.setenv("MXTPU_PS_ROOT_URI", "127.0.0.1")
    monkeypatch.setenv("MXTPU_PS_HEARTBEAT_INTERVAL", "0.1")
    monkeypatch.setenv("MXTPU_KVSTORE_BIGARRAY_BOUND", "50")
    for name in ("MXTPU_PS_SECRET", "MXTPU_PS_REPLICATION", "MXTPU_ROLE",
                 "DMLC_ROLE", "DMLC_PS_ROOT_PORT", "DMLC_NUM_WORKER",
                 "DMLC_NUM_SERVER"):
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


@contextlib.contextmanager
def job(env, infra, workers, nw=2, ns=2):
    """A scheduler and ``ns`` servers of the package ``infra`` in
    threads, and ``nw`` workers of the package ``workers``; on exit the
    workers close, which shuts the job down, and every thread started
    here must end."""
    before = set(threading.enumerate())
    env.setenv("MXTPU_NUM_WORKER", str(nw))
    env.setenv("MXTPU_NUM_SERVER", str(ns))
    sched = infra.Scheduler(port=0)
    env.setenv("MXTPU_PS_ROOT_PORT", str(sched._port))
    threading.Thread(target=sched.run, daemon=True).start()
    for _ in range(ns):
        threading.Thread(target=lambda: infra.Server().run(),
                         daemon=True).start()
    ws = _within(30, lambda: [workers.Worker() for _ in range(nw)])
    try:
        yield ws
    finally:
        _within(30, lambda: [w.close() for w in ws])
        join_new_threads(before)


# ---------------------------------------------------------------------------
# Wire
# ---------------------------------------------------------------------------

RNG = np.random.RandomState(0)
FRAMES = [
    {"op": "push", "key": ("weight", 0), "sync": True, "worker": 9,
     "round": 3, "value": RNG.randn(7, 3).astype(np.float32)},
    {"op": "push_rows", "key": (3, 1), "sync": False, "worker": 11,
     "spans": np.array([[0, 4], [8, 12]], np.int64),
     "value": RNG.randn(8).astype(np.float32)},
    {"op": "pull_rows", "key": ("e", 0), "min_version": 2,
     "spans": np.zeros((0, 2), np.int64)},
    {"op": "command", "head": "set_optimizer", "body": b"\x80\x04opaque"},
    {"ok": True, "version": np.int64(5), "scale": np.float32(0.5),
     "nested": [1, 2.5, None, ("a", [np.arange(3, dtype=np.int32)])],
     "ids": np.arange(4, dtype=np.uint8), "f64": np.ones((2, 2))},
    {"rank": 0, "servers": [["127.0.0.1", 4242]], "gen": 0},
]


class _Tap(object):
    """A socket that keeps what is sent to it."""

    def __init__(self):
        self.data = b""

    def sendall(self, b):
        self.data += b


def _same(a, b):
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a == b and type(a) is type(b), (a, b)


@pytest.mark.parametrize("i", range(len(FRAMES)))
@pytest.mark.parametrize("secret", [None, "s3cret"])
def test_codecs_write_the_same_bytes_and_read_each_other(i, secret, ps_env):
    if secret:
        ps_env.setenv("MXTPU_PS_SECRET", secret)
    frame = FRAMES[i]
    assert T._encode(frame) == J._encode(frame)
    taps = _Tap(), _Tap()
    T._send_msg(taps[0], frame)
    J._send_msg(taps[1], frame)
    assert taps[0].data == taps[1].data
    payload = J._encode(frame)
    _same(T._decode(payload), J._decode(payload))


def test_a_wrong_hmac_is_refused(ps_env):
    ps_env.setenv("MXTPU_PS_SECRET", "one")
    tap = _Tap()
    J._send_msg(tap, FRAMES[0])
    ps_env.setenv("MXTPU_PS_SECRET", "two")

    class _Feed(object):
        def __init__(self, data):
            self.data = data

        def recv(self, n):
            out, self.data = self.data[:n], self.data[n:]
            return out

    with pytest.raises(ConnectionError, match="HMAC"):
        T._recv_msg(_Feed(tap.data))


class _FakeServers(object):
    """Both workers' server requests, answered from flat arrays held
    per subkey, and recorded as encoded frames."""

    def __init__(self):
        self.store, self.sent = {}, []

    def __call__(self, sidx, msg, timeout=None):
        self.sent.append((sidx, J._encode(msg)))
        key, op = msg.get("key"), msg["op"]
        if op == "init":
            self.store[key] = np.array(msg["value"])
            return {"ok": True}
        if op in ("push", "push_rows"):
            return {"version": msg.get("round", 1)}
        if op == "pull":
            return {"value": self.store[key], "version": 1}
        spans = np.asarray(msg["spans"]).reshape(-1, 2)
        return {"value": np.concatenate(
            [self.store[key][a:b] for a, b in spans]), "version": 1}


def _bare_worker(P, ns):
    """A Worker of package P over ``ns`` fake servers."""
    w = object.__new__(P.Worker)
    w._servers = [None] * ns
    w._server_addrs = [("127.0.0.1", 1)] * ns
    w._bigarray = 50
    w._meta_shape, w._last_version = {}, {}
    w.node_id, w.rank, w.num_workers = 9, 0, 1
    # the reference's elastic state, idle
    w._smap, w._needs_join, w._join_version = list(range(ns)), False, 0
    w._repl_on, w._inflight = False, {}
    w._server_request = _FakeServers()
    return w


@pytest.mark.parametrize("ns", [1, 2])
def test_workers_send_the_same_frames_and_assemble_the_same_rows(ns):
    got = {}
    for P in (J, T):
        rng = np.random.RandomState(1)
        value = rng.randn(40, 3).astype(np.float32)  # 120 >= the bound
        small = rng.randn(5).astype(np.float32)
        w = _bare_worker(P, ns)
        w.init("w", value)
        w.init(7, small)
        assert [c[:2] for c in w._chunks("w", 120)] == \
            [c[:2] for c in J.Worker._chunks(w, "w", 120)]
        w.push("w", value * 2)
        w.push(7, small, sync=False)
        w.push_rows("w", np.array([33, 2, 17]), rng.randn(3, 3)
                    .astype(np.float32))
        w.push_rows("w", np.zeros(0, np.int64), np.zeros((0, 3), np.float32))
        pulled = w.pull("w")
        rows = w.pull_rows("w", np.array([39, 0, 17, 17, 41, 20]))
        empty = w.pull_rows("w", np.zeros(0, np.int64))
        got[P] = (w._server_request.sent, pulled, rows, empty)
    (jsent, jpull, jrows, jempty), (tsent, tpull, trows, tempty) = \
        got[J], got[T]
    assert len(tsent) == len(jsent)
    for a, b in zip(tsent, jsent):
        assert a == b
    np.testing.assert_array_equal(tpull, jpull)
    for a, b in zip(trows + tempty, jrows + jempty):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# Traffic across the packages
# ---------------------------------------------------------------------------

def _traffic(ws, sync):
    """Dense and rows-only pushes from both workers, then pulls;
    returns what each worker pulled."""
    rng = np.random.RandomState(2)
    w0, w1 = ws
    dense = rng.randn(20, 4).astype(np.float32)     # striped over 2
    w0.init("d", dense)
    w0.init(5, np.zeros((30, 2), np.float32))
    w1.register_meta("d", dense.shape, dense.dtype)
    w1.register_meta(5, (30, 2), np.float32)
    g = [rng.randn(20, 4).astype(np.float32) for _ in range(2)]
    rows = [np.array([3, 29, 11]), np.array([11, 0])]
    data = [rng.randn(len(r), 2).astype(np.float32) for r in rows]
    for w, gi, r, d in zip(ws, g, rows, data):
        w.push("d", gi, sync=sync)
        w.push_rows(5, r, d, sync=sync)
    pulled = [(w.pull("d", sync=sync),
               w.pull_rows(5, np.array([0, 3, 11, 12, 29]), sync=sync))
              for w in ws]
    dense_rows = []
    for r, d in zip(rows, data):
        full = np.zeros((30, 2), np.float32)
        full[r] = d
        dense_rows.append(full)
    if sync:
        want = g[0] + g[1], dense_rows[0] + dense_rows[1]
    else:  # each push replaces the value; w1 pushed last
        want = g[1], dense_rows[1]
    return pulled, want


@pytest.mark.parametrize("sync", [True, False], ids=["sync", "async"])
@pytest.mark.parametrize("infra,workers", [(J, T), (T, J)],
                         ids=["port_workers", "reference_workers"])
def test_workers_and_servers_of_the_two_packages_talk(infra, workers, sync,
                                                      ps_env):
    with job(ps_env, infra, workers) as ws:
        pulled, (want_d, want_rows) = _within(30, lambda: _traffic(ws,
                                                                   sync))
    for d, (rows, vals) in pulled:
        np.testing.assert_array_equal(d, want_d)
        np.testing.assert_array_equal(rows, [0, 3, 11, 12, 29])
        np.testing.assert_array_equal(vals, want_rows[rows])


# ---------------------------------------------------------------------------
# Parity with an optimizer on the servers
# ---------------------------------------------------------------------------

OPTIMIZERS = {
    "sgd": dict(learning_rate=0.1, momentum=0.9, wd=1e-3, rescale_grad=0.5),
    "adagrad": dict(learning_rate=0.1, rescale_grad=0.5),
}


def _train(P, ws, opt, sync, rounds=3):
    """The same gradients, rounds x (both workers push, then pull);
    returns every pull of every round."""
    rng = np.random.RandomState(3)
    w0, w1 = ws
    init = {"w": rng.randn(40, 3).astype(np.float32),
            7: rng.randn(5).astype(np.float32),
            "e": rng.randn(30, 2).astype(np.float32)}
    for k, v in init.items():
        w0.init(k, v)
        w1.register_meta(k, v.shape, v.dtype)
    mx = jmx if P is J else tmx
    w0.send_command("set_optimizer", pickle.dumps(
        mx.optimizer.create(opt, **OPTIMIZERS[opt])))
    out = []
    for _ in range(rounds):
        for w in ws:
            w.push("w", rng.randn(40, 3).astype(np.float32), sync=sync)
            w.push(7, rng.randn(5).astype(np.float32), sync=sync)
            rows = rng.choice(30, size=6, replace=False)
            w.push_rows("e", rows, rng.randn(6, 2).astype(np.float32),
                        sync=sync)
        for w in ws:
            out.append([w.pull("w", sync=sync), w.pull(7, sync=sync),
                        w.pull_rows("e", np.arange(30), sync=sync)[1]])
    return out


@pytest.mark.parametrize("sync", [True, False], ids=["sync", "async"])
@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_parameter_servers_agree_with_the_reference(opt, sync, ps_env):
    runs = {}
    for P in (J, T):
        with job(ps_env, P, P) as ws:
            runs[P] = _within(60, lambda: _train(P, ws, opt, sync))
    assert len(runs[T]) == len(runs[J]) == 6
    for tp, jp in zip(runs[T], runs[J]):
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a, b, **PARITY)
    init_w = np.random.RandomState(3).randn(40, 3).astype(np.float32)
    assert not np.allclose(runs[T][-1][0], init_w)
    if sync:  # both workers of a round read the same weights
        for r in range(0, 6, 2):
            for a, b in zip(runs[T][r], runs[T][r + 1]):
                np.testing.assert_array_equal(a, b)


def test_elastic_settings_raise_and_name_a17(ps_env):
    ps_env.setenv("MXTPU_PS_REPLICATION", "1")
    for make in (lambda: T.Scheduler(port=0), T.Server, T.Worker):
        with pytest.raises(tmx.MXNetError, match="A17"):
            make()
