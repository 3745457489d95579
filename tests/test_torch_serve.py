"""The PyTorch port's server (`mxtpu_torch/serve.py`) against the JAX
package's `mx.serve.Server`, and the port's micro-batcher, admission
control, OOM degradation and drain on their own (the relevant cases of
`tests/test_serving.py`, ported).

Both servers host the same small TransformerLM forward as a plain
callable returning the last position's logits (the next-token server);
the port's runs on the CPU.
"""
import threading
import time

import numpy as np
import pytest
import torch

import jax

import mxtpu as mx
from mxtpu.parallel import transformer as jtf
from mxtpu.parallel.mesh import (AXIS_DP, AXIS_EP, AXIS_PP, AXIS_SP,
                                 AXIS_TP, create_mesh)
from mxtpu_torch import compile_cache as tcc
from mxtpu_torch import serve as tserve
from mxtpu_torch.base import (MemoryExhaustedError, MXNetError,
                              RequestShedError)
from mxtpu_torch.parallel import transformer as ttf

torch.set_num_threads(1)

SMALL = dict(vocab=64, d_model=64, n_heads=4, n_layers=2, d_ff=128,
             max_len=32, dtype="float32")
T = 32


def _next_token_models():
    """(jax_fn, port_fn): tokens int32 [b, T] -> float32 [b, vocab]."""
    mesh = create_mesh({AXIS_DP: 1, AXIS_PP: 1, AXIS_TP: 1, AXIS_SP: 1,
                        AXIS_EP: 1}, devices=jax.devices()[:1])
    jcfg = jtf.TransformerConfig(**SMALL)
    jparams = jtf.init_params(jcfg, mesh, seed=5)
    jfwd = jtf.make_forward(jcfg, mesh)
    tcfg = ttf.TransformerConfig(**SMALL)
    tparams = ttf.params_from_jax({k: np.asarray(v)
                                   for k, v in jparams.items()},
                                  tcfg, "cpu")
    tfwd = ttf.make_forward(tcfg, "cpu")

    def jax_fn(toks):
        return np.asarray(jfwd(jparams, toks))[:, -1].astype(np.float32)

    def port_fn(toks):
        return tfwd(tparams, toks)[:, -1].float().numpy()

    return jax_fn, port_fn


def test_next_token_server_matches_jax_server():
    """Ragged requests of 1, 3 and 2 rows through both servers: every
    request's rows agree across the packages (f32 bound of
    `tests/test_parallel.py`), and with the port's own unbatched
    forward."""
    jax_fn, port_fn = _next_token_models()
    rng = np.random.RandomState(0)
    reqs = [rng.randint(0, SMALL["vocab"], (n, T)).astype(np.int32)
            for n in (1, 3, 2)]
    outs = {}
    for name, server_cls, fn in (("jax", mx.serve.Server, jax_fn),
                                 ("port", tserve.Server, port_fn)):
        srv = server_cls(max_batch=8, batch_wait_s=0.05)
        try:
            srv.add_model("lm", fn, input_shape=(T,), dtype="int32")
            srv.start()
            futs = [srv.submit("lm", x) for x in reqs]
            outs[name] = [f.result(60) for f in futs]
        finally:
            srv.close()
    for x, j, p in zip(reqs, outs["jax"], outs["port"]):
        assert p.shape == j.shape == (x.shape[0], SMALL["vocab"])
        np.testing.assert_allclose(p, j, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(p, port_fn(x), rtol=1e-5, atol=1e-5)


@pytest.fixture
def server():
    srv = tserve.Server(max_batch=8, batch_wait_s=0.002)
    yield srv
    srv.close()


# -- buckets -----------------------------------------------------------------

@pytest.mark.parametrize("spec,cap,want", [
    ("pow2", 32, [1, 2, 4, 8, 16, 32]),
    ("pow2", 20, [1, 2, 4, 8, 16]),
    ("mult:3", 10, [3, 6, 9]),
    ("fixed:2,5,50", 8, [2, 5]),
])
def test_bucket_set_matches_jax(spec, cap, want):
    from mxtpu import compile_cache as jcc

    assert tcc.bucket_set(cap, spec) == jcc.bucket_set(cap, spec) == want
    for n in range(1, cap + 1):
        assert tcc.bucket_batch(n, spec) == jcc.bucket_batch(n, spec)


def test_bucket_policy_from_env(monkeypatch):
    monkeypatch.setenv("MXTPU_SHAPE_BUCKETS", "1")
    assert tcc.get_bucket_policy() == "pow2"
    monkeypatch.setenv("MXTPU_SHAPE_BUCKETS", "off")
    assert tcc.get_bucket_policy() is None
    assert tcc.bucket_batch(5) == 5
    with pytest.raises(MXNetError, match="bucket policy"):
        tserve.Server(bucket_spec="bogus")


def test_batches_pad_to_the_bucket_and_slice_back():
    """Ragged requests packed into one call are zero-padded to the pow2
    bucket; each request gets exactly its own rows back."""
    shapes = []
    gate = threading.Event()

    def model(x):
        shapes.append(x.shape[0])
        gate.wait(10)
        return x * 2.0

    srv = tserve.Server(max_batch=8, batch_wait_s=0.2)
    srv.add_model("m", model, input_shape=(2,))
    srv.start()
    try:
        xs = [np.full((n, 2), i, "float32") for i, n in enumerate((1, 2))]
        futs = [srv.submit("m", x) for x in xs]
        gate.set()
        for x, f in zip(xs, futs):
            np.testing.assert_array_equal(f.result(10), 2 * x)
        assert shapes == [4]  # 3 rows -> the 4-row bucket, one call
        assert srv.metrics()["batch_occupancy_pct"] == 75.0
    finally:
        gate.set()
        srv.close()


def test_effective_cap_snaps_to_a_bucket():
    srv = tserve.Server(max_batch=20)
    try:
        srv.add_model("m", lambda x: x, input_shape=(3,))
        e = srv._entries["m"]
        assert e.buckets == [1, 2, 4, 8, 16]
        assert e.max_batch == 16
    finally:
        srv.close()


# -- requests ------------------------------------------------------------------

def test_single_sample_promotion_and_bad_requests(server):
    server.add_model("m", lambda x: x + 1.0, input_shape=(10,))
    with pytest.raises(MXNetError, match="not started"):
        server.submit("m", np.ones((1, 10), "float32"))
    server.start()
    assert server.infer("m", np.zeros(10, "float32")).shape == (1, 10)
    with pytest.raises(MXNetError, match="unknown model"):
        server.submit("nope", np.zeros((1, 10), "float32"))
    with pytest.raises(MXNetError, match="sample shape"):
        server.submit("m", np.zeros((1, 7), "float32"))
    with pytest.raises(MXNetError, match="already hosted"):
        server.add_model("m", lambda x: x)
    with pytest.raises(MXNetError, match="callable"):
        server.add_model("n", 3)


def test_module_hosting(server):
    """A ``torch.nn.Module`` is hosted through ``_as_predict``: the rows
    reach it as a tensor on its parameters' device, and its outputs (a
    tuple here, one of them bf16) come back as float32 numpy rows."""
    class Scale(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(
                torch.full((3,), 2.0, dtype=torch.bfloat16))

        def forward(self, x):
            assert x.device == self.w.device
            return x.to(torch.bfloat16) * self.w, x + 1.0

    server.add_model("mod", Scale(), input_shape=(3,))
    server.start()
    x = np.arange(6, dtype="float32").reshape(2, 3)
    doubled, plus1 = server.infer("mod", x)
    assert doubled.dtype == plus1.dtype == np.float32
    np.testing.assert_array_equal(doubled, 2 * x)
    np.testing.assert_array_equal(plus1, x + 1.0)


def test_multi_model_isolation(server):
    """A model that raises fails only its own requests."""
    def broken(x):
        raise ValueError("broken model")

    server.add_model("a", lambda x: x + 1.0, input_shape=(4,))
    server.add_model("broken", broken, input_shape=(4,))
    server.start()
    x = np.ones((3, 4), "float32")
    fbad = server.submit("broken", x)
    np.testing.assert_array_equal(server.infer("a", x), x + 1.0)
    with pytest.raises(ValueError, match="broken model"):
        fbad.result(30)
    np.testing.assert_array_equal(server.infer("a", x), x + 1.0)


def test_non_batch_major_output_fails_typed(server):
    server.add_model("m", lambda x: np.zeros((3, 1), "float32"),
                     input_shape=(1,))
    server.start()
    with pytest.raises(MXNetError, match="batch-major"):
        server.infer("m", np.ones((1, 1), "float32"))


# -- admission control ---------------------------------------------------------

def test_admission_control_sheds_per_tenant():
    """One tenant over its queued-row cap sheds typed at submit; an
    under-cap tenant on the SAME model is still admitted."""
    gate = threading.Event()
    started = threading.Event()

    def slow(x):
        started.set()
        gate.wait(10)
        return x * 2.0

    srv = tserve.Server(max_batch=2, queue_cap=4, batch_wait_s=0.0)
    srv.add_model("slow", slow, input_shape=(3,))
    srv.start()
    try:
        plug = srv.submit("slow", np.ones((2, 3), "float32"),
                          tenant="greedy")
        assert started.wait(10)  # the batcher is now held in the model
        futs = [srv.submit("slow", np.ones((2, 3), "float32"),
                           tenant="greedy") for _ in range(2)]
        with pytest.raises(RequestShedError) as ei:
            srv.submit("slow", np.ones((1, 3), "float32"),
                       tenant="greedy")
        assert ei.value.reason == "queue_full"
        fut_polite = srv.submit("slow", np.ones((1, 3), "float32"),
                                tenant="polite")
        gate.set()
        for f in [plug] + futs:
            np.testing.assert_array_equal(f.result(30),
                                          2 * np.ones((2, 3), "f"))
        assert fut_polite.result(30).shape == (1, 3)
    finally:
        gate.set()
        srv.close()


def test_queue_timeout_sheds_typed():
    gate = threading.Event()

    def slow(x):
        gate.wait(10)
        return x

    srv = tserve.Server(max_batch=2, batch_wait_s=0.0,
                        request_timeout_s=0.2)
    srv.add_model("slow", slow, input_shape=(1,))
    srv.start()
    try:
        first = srv.submit("slow", np.ones((1, 1), "float32"))
        stuck = srv.submit("slow", np.ones((2, 1), "float32"))
        time.sleep(0.4)  # stuck's deadline lapses while queued
        gate.set()
        first.result(30)
        with pytest.raises(RequestShedError) as ei:
            stuck.result(30)
        assert ei.value.reason == "timeout"
    finally:
        gate.set()
        srv.close()


def test_expired_head_cannot_overpack_past_cap():
    """An expired request shed at the queue head mid-gather must not
    admit its unchecked successor past the cap."""
    shapes = []
    gate = threading.Event()
    first_call = threading.Event()

    def model(x):
        shapes.append(x.shape[0])
        if not first_call.is_set():
            first_call.set()
            gate.wait(10)
        return x

    srv = tserve.Server(max_batch=8, batch_wait_s=0.0)
    srv.add_model("m", model, input_shape=(1,))
    srv.start()
    try:
        plug = srv.submit("m", np.ones((1, 1), "float32"))
        assert first_call.wait(10)
        fa = srv.submit("m", np.ones((6, 1), "float32"))
        fb = srv.submit("m", np.ones((1, 1), "float32"), timeout=0.01)
        fc = srv.submit("m", np.ones((8, 1), "float32"))
        time.sleep(0.1)  # fb's deadline expires in-queue
        gate.set()
        assert plug.result(10).shape == (1, 1)
        assert fa.result(10).shape == (6, 1)
        with pytest.raises(RequestShedError):
            fb.result(10)
        assert fc.result(10).shape == (8, 1)
        assert max(shapes) <= 8, "batch packed past the cap: %s" % shapes
    finally:
        srv.close()


# -- OOM degradation -----------------------------------------------------------

@pytest.mark.parametrize("oom", [torch.cuda.OutOfMemoryError,
                                 MemoryExhaustedError])
def test_oom_shrinks_bucket_and_retries(oom):
    """Device-memory exhaustion on dispatch SHRINKS the bucket cap,
    requeues the batch, and every admitted request still completes; a
    request wider than the shrunken cap then fails typed."""
    calls = []

    def oomy(x):
        calls.append(x.shape[0])
        if x.shape[0] > 4:
            raise oom("injected device memory exhaustion")
        return x + 1.0

    srv = tserve.Server(max_batch=8, batch_wait_s=0.05)
    srv.add_model("oomy", oomy, input_shape=(2,))
    srv.start()
    try:
        futs = [srv.submit("oomy", np.full((n, 2), i, "float32"))
                for i, n in enumerate((3, 3, 2))]  # 8 rows -> bucket 8
        for i, (n, f) in enumerate(zip((3, 3, 2), futs)):
            np.testing.assert_array_equal(
                f.result(30), np.full((n, 2), i, "float32") + 1.0)
        assert max(calls) > 4
        assert srv._entries["oomy"].max_batch <= 4
        with pytest.raises(oom):
            srv.infer("oomy", np.ones((6, 2), "float32"))
    finally:
        srv.close()


def test_oom_at_floor_bucket_fails_typed_fast():
    def always_oom(x):
        raise torch.cuda.OutOfMemoryError("injected")

    srv = tserve.Server(max_batch=8, batch_wait_s=0.002)
    srv.add_model("oom", always_oom, input_shape=(2,))
    srv.start()
    try:
        t0 = time.monotonic()
        with pytest.raises(torch.cuda.OutOfMemoryError):
            srv.infer("oom", np.ones((1, 2), "float32"))
        assert time.monotonic() - t0 < 10.0
        assert srv._entries["oom"].max_batch == 8
    finally:
        srv.close()


# -- drain and metrics ---------------------------------------------------------

def test_drain_finishes_admitted_work_then_sheds():
    gate = threading.Event()

    def slow(x):
        gate.wait(10)
        return x

    srv = tserve.Server(max_batch=2, batch_wait_s=0.0)
    srv.add_model("slow", slow, input_shape=(1,))
    srv.start()
    admitted = [srv.submit("slow", np.ones((1, 1), "float32"))
                for _ in range(3)]
    drained = []
    t = threading.Thread(target=lambda: drained.append(srv.drain(30)))
    t.start()
    time.sleep(0.05)
    with pytest.raises(RequestShedError) as ei:
        srv.submit("slow", np.ones((1, 1), "float32"))
    assert ei.value.reason == "draining"
    assert srv.draining
    gate.set()
    t.join(30)
    assert not t.is_alive() and drained == [True]
    for f in admitted:
        assert f.result(1).shape == (1, 1)
    with pytest.raises(MXNetError, match="stopped"):
        srv.add_model("late", lambda x: x)
    srv.close()


def test_concurrent_clients_get_their_own_rows(server):
    """Many submitting threads, one batcher: every request gets exactly
    its own rows back, and continuous batching packed some of them."""
    calls = []

    def model(x):
        calls.append(x.shape[0])
        return x * 3.0

    server.add_model("m", model, input_shape=(5,))
    server.start()
    failures = []

    def client(i):
        rng = np.random.RandomState(i)
        for _ in range(10):
            x = rng.rand(int(rng.randint(1, 4)), 5).astype("float32")
            if not np.array_equal(server.infer("m", x, timeout=30), x * 3.0):
                failures.append(i)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    assert not failures
    assert len(calls) <= 60


def test_metrics_report_latency_percentiles(server):
    server.add_model("metrics_m", lambda x: x, input_shape=(4,))
    server.start()
    for n in (1, 3, 5):
        server.infer("metrics_m", np.random.rand(n, 4).astype("float32"))
    m = server.metrics()
    assert m["queue_depth"] == 0 and m["inflight"] == 0
    assert 0 < m["batch_occupancy_pct"] <= 100
    mm = m["models"]["metrics_m"]
    assert mm["requests"] >= 3 and mm["max_batch"] == 8
    assert 0 < mm["latency_p50_s"] <= mm["latency_p99_s"]
