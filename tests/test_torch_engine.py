"""The PyTorch port's dependency engine (`mxtpu_torch/engine.py`) and
`io.PrefetchingIter` on it, against the JAX package's
(`mxtpu/engine.py`, `mxtpu/io/io.py`): the scenarios of
`tests/test_native.py` (write order, concurrent reads, read/write
order, a randomized workload replayed serially, an error raised at the
wait, a variable both read and written) on both engines, the prefetcher
overlapping its consumer on the threaded engine and running at the push
on the naive one, its batches equal to the reference's, the engine's
choice by `MXTPU_ENGINE_TYPE`, and its build into `mxtpu_torch/_build/`.

Every threaded engine a test makes is closed at its end, which joins
its worker threads.
"""
import threading
import time

import numpy as np
import pytest
import torch

import mxtpu as jmx
import mxtpu_torch as tmx
from mxtpu_torch import engine as teng
from mxtpu_torch.base import MXNetError

torch.set_num_threads(1)


@pytest.fixture
def threaded():
    eng = teng.ThreadedEngine(num_threads=4)
    yield eng
    eng.close()


@pytest.fixture(params=["threaded", "naive"])
def engine(request):
    if request.param == "naive":
        yield teng.NaiveEngine()
        return
    eng = teng.ThreadedEngine(num_threads=4)
    yield eng
    eng.close()


@pytest.fixture
def as_process_engine():
    """Make an engine the process's for the test, then restore."""
    prev = teng._engine

    def install(eng):
        teng.set_engine(eng)
        return eng
    yield install
    teng.set_engine(prev)


def test_write_ordering(engine):
    v = engine.new_var()
    out = []
    for i in range(50):
        engine.push(lambda i=i: out.append(i), mutable_vars=[v])
    engine.wait_for_var(v)
    assert out == list(range(50))
    assert v.version == 50 == engine.var_version(v)


def test_parallel_reads(threaded):
    v = threaded.new_var()
    active, peak = [], []
    lock = threading.Lock()

    def reader():
        with lock:
            active.append(1)
            peak.append(len(active))
        time.sleep(0.02)
        with lock:
            active.pop()

    for _ in range(8):
        threaded.push(reader, const_vars=[v])
    threaded.wait_for_all()
    assert max(peak) > 1, "no read concurrency observed"


def test_read_write_dependency(engine):
    v = engine.new_var()
    log = []

    def slow_read():
        time.sleep(0.03)
        log.append("r1")

    engine.push(slow_read, const_vars=[v])
    engine.push(lambda: log.append("w"), mutable_vars=[v])
    engine.push(lambda: log.append("r2"), const_vars=[v])
    engine.wait_for_all()
    assert log == ["r1", "w", "r2"]


@pytest.mark.parametrize("seed", [0, 1])
def test_randomized_workload_matches_a_serial_replay(engine, seed):
    rng = np.random.RandomState(seed)
    n_vars = 8
    values = np.zeros(n_vars)
    eng_vars = [engine.new_var() for _ in range(n_vars)]
    ops = []
    for _ in range(200):
        dst = rng.randint(n_vars)
        srcs = list(rng.choice(n_vars, rng.randint(1, 4), replace=False))
        ops.append((dst, srcs, float(rng.rand())))
    for dst, srcs, coef in ops:
        def fn(dst=dst, srcs=srcs, coef=coef):
            values[dst] = values[dst] * 0.5 + coef * sum(
                values[s] for s in srcs) + 1.0
        engine.push(fn, const_vars=[eng_vars[s] for s in srcs if s != dst],
                    mutable_vars=[eng_vars[dst]])
    engine.wait_for_all()
    expected = np.zeros(n_vars)
    for dst, srcs, coef in ops:
        expected[dst] = expected[dst] * 0.5 + coef * sum(
            expected[s] for s in srcs) + 1.0
    np.testing.assert_allclose(values, expected, rtol=1e-10)


def test_async_error_surfaces_at_wait(threaded):
    v = threaded.new_var()

    def boom():
        raise ValueError("kaboom")

    threaded.push(boom, mutable_vars=[v])
    with pytest.raises(MXNetError, match="kaboom"):
        threaded.wait_for_var(v)
    # the variable is usable after the error
    out = []
    threaded.push(lambda: out.append(1), mutable_vars=[v])
    threaded.wait_for_var(v)
    assert out == [1]


def test_naive_engine_matches_the_reference():
    from mxtpu.engine import NaiveEngine

    logs = []
    for eng in (teng.NaiveEngine(), NaiveEngine()):
        v = eng.new_var()
        out = []
        eng.push(lambda: out.append(1), mutable_vars=[v])
        eng.wait_for_var(v)
        with pytest.raises(ZeroDivisionError):
            eng.push(lambda: 1 / 0, mutable_vars=[v])
        err = MXNetError if isinstance(eng, teng.NaiveEngine) \
            else jmx.MXNetError
        with pytest.raises(err, match="division"):
            eng.wait_for_var(v)
        eng.wait_for_var(v)  # raised once
        logs.append((out, eng.var_version(v)))
    assert logs[0] == logs[1] == ([1], 2)


def test_overlapping_const_and_mutable_vars(engine):
    v = engine.new_var()
    hits = []
    engine.push(lambda: hits.append(1), const_vars=[v], mutable_vars=[v])
    engine.push(lambda: hits.append(2), const_vars=[v, v],
                mutable_vars=[v, v])
    engine.wait_for_all()
    assert hits == [1, 2]


def test_delete_var_after_its_writes(threaded):
    v = threaded.new_var()
    out = []
    threaded.push(lambda: (time.sleep(0.02), out.append(1)),
                  mutable_vars=[v])
    threaded.delete_var(v)
    threaded.wait_for_all()
    assert out == [1] and threaded.num_outstanding() == 0


def test_closed_engine_takes_no_push():
    eng = teng.ThreadedEngine(num_threads=2)
    v = eng.new_var()
    eng.push(lambda: time.sleep(0.01), mutable_vars=[v])
    eng.close()
    with pytest.raises(MXNetError, match="closed"):
        eng.push(lambda: None, mutable_vars=[v])
    eng.close()


class _SlowIter(tmx.io.DataIter):
    """A source whose next() costs ``delay`` seconds."""

    def __init__(self, n, delay, batch_size=2):
        super().__init__(batch_size)
        self.n, self.delay = n, delay
        self._i = 0
        self.produced = 0
        self.threads = set()
        self.provide_data = [tmx.io.DataDesc("data", (batch_size, 2))]
        self.provide_label = [tmx.io.DataDesc("softmax_label",
                                              (batch_size,))]

    def reset(self):
        self._i = 0

    def next(self):
        if self._i >= self.n:
            raise StopIteration
        self._i += 1
        time.sleep(self.delay)
        self.threads.add(threading.get_ident())
        batch = tmx.io.DataBatch(
            data=[tmx.nd.zeros((self.batch_size, 2), ctx=tmx.cpu()) + self._i],
            label=[tmx.nd.zeros((self.batch_size,), ctx=tmx.cpu())])
        self.produced += 1
        return batch


def _drain(it):
    out = []
    while True:
        try:
            out.append(it.next())
        except StopIteration:
            return out


def test_prefetching_iter_overlaps_on_the_threaded_engine(
        as_process_engine):
    eng = as_process_engine(teng.ThreadedEngine(num_threads=2))
    try:
        # a loaded machine can starve the producer for a whole epoch;
        # a serial producer never runs ahead in any attempt
        for _ in range(6):
            n, delay = 10, 0.03
            src = _SlowIter(n, delay)
            it = tmx.io.PrefetchingIter(src, prefetch_depth=3)
            count, max_ahead = 0, 0
            while True:
                try:
                    it.next()
                except StopIteration:
                    break
                count += 1
                time.sleep(delay)
                max_ahead = max(max_ahead, src.produced - count)
            it.close()
            assert count == n
            assert threading.get_ident() not in src.threads
            if max_ahead >= 1:
                break
        assert max_ahead >= 1, "the producer never ran ahead"
    finally:
        eng.close()


def test_prefetching_iter_runs_at_the_push_on_the_naive_engine(
        as_process_engine, monkeypatch):
    monkeypatch.setenv("MXTPU_ENGINE_TYPE", "NaiveEngine")
    teng.set_engine(None)
    assert isinstance(teng.get_engine(), teng.NaiveEngine)
    src = _SlowIter(6, 0.0)
    it = tmx.io.PrefetchingIter(src, prefetch_depth=2)
    assert src.produced == 2  # the two primed tasks ran at their push
    first = _drain(it)
    it.reset()
    second = _drain(it)
    assert len(first) == len(second) == 6
    assert src.threads == {threading.get_ident()}
    assert [b.data[0].asnumpy()[0, 0] for b in second] == \
        [float(i) for i in range(1, 7)]


@pytest.mark.parametrize("kind", ["threaded", "naive"])
def test_prefetching_iter_batches_match_the_reference(as_process_engine,
                                                      kind):
    eng = as_process_engine(teng.ThreadedEngine(num_threads=2)
                            if kind == "threaded" else teng.NaiveEngine())
    rng = np.random.RandomState(0)
    x = rng.randn(11, 3).astype(np.float32)
    y = rng.randint(0, 4, 11).astype(np.float32)
    try:
        got = []
        for mx, kw in ((tmx, dict(ctx=tmx.cpu())), (jmx, {})):
            it = mx.io.PrefetchingIter(
                [mx.io.NDArrayIter(x, y, batch_size=4, **kw),
                 mx.io.NDArrayIter(x + 1, y, batch_size=4, data_name="d2",
                                   label_name="l2", **kw)],
                rename_data=[{"data": "a"}, {"d2": "b"}], prefetch_depth=3)
            epochs = []
            for _ in range(2):
                epochs.append([([d.asnumpy() for d in b.data],
                                [lb.asnumpy() for lb in b.label], b.pad)
                               for b in _drain(it)])
                it.reset()
            got.append(epochs)
        t, j = got
        assert len(t[0]) == len(j[0]) == 3 and len(t) == len(j)
        for te, je in zip(t, j):
            for (td, tl, tp), (jd, jl, jp) in zip(te, je):
                assert tp == jp
                for a, b in zip(td + tl, jd + jl):
                    np.testing.assert_array_equal(a, b)
    finally:
        if kind == "threaded":
            eng.close()


def test_prefetching_iter_raises_the_producers_error(as_process_engine):
    eng = as_process_engine(teng.ThreadedEngine(num_threads=2))

    class Broken(tmx.io.DataIter):
        batch_size = 1
        provide_data = provide_label = []

        def next(self):
            raise RuntimeError("broken source")

    try:
        it = tmx.io.PrefetchingIter(Broken())
        with pytest.raises(RuntimeError, match="broken source"):
            it.next()
        with pytest.raises(StopIteration):
            it.next()
        it.close()
    finally:
        eng.close()


def test_engine_type_chooses_the_engine(as_process_engine, monkeypatch):
    for var in ("MXTPU_ENGINE_TYPE", "MXNET_ENGINE_TYPE"):
        monkeypatch.delenv("MXTPU_ENGINE_TYPE", raising=False)
        monkeypatch.setenv(var, "NaiveEngine")
        teng.set_engine(None)
        assert isinstance(teng.get_engine(), teng.NaiveEngine)
        assert teng.get_engine() is teng.get_engine()
    monkeypatch.setenv("MXTPU_ENGINE_TYPE", "ThreadedEngine")
    teng.set_engine(None)
    eng = teng.get_engine()
    try:
        assert isinstance(eng, teng.ThreadedEngine)
    finally:
        eng.close()


def test_the_library_is_built_into_the_ports_build_directory():
    lib = teng.library_path()
    assert lib.parent == teng.BUILD_DIR
    assert teng.BUILD_DIR.parent.name == "mxtpu_torch"
    assert teng.BUILD_DIR.name == "_build"
    teng.get_lib()
    assert lib.exists()
    assert str(lib) in tmx.libinfo.find_lib_path()


def test_a_failed_build_raises_with_the_compilers_error(tmp_path,
                                                        monkeypatch):
    src = tmp_path / "src"
    (src / "include").mkdir(parents=True)
    (src / "include" / "mxtpu_runtime.h").write_text("")
    (src / "engine.cc").write_text("int broken( {\n")
    monkeypatch.setattr(teng, "SRC_DIR", src)
    with pytest.raises(MXNetError, match="building the engine failed"):
        teng.build(tmp_path / "build")
    assert not any((tmp_path / "build").glob("*.so"))
