"""Optimizer-state checkpoints and the iterators of the PyTorch port,
on the CPU.

* `Module.save_checkpoint(save_optimizer_states=True)` then
  `Module.load(..., load_optimizer_states=True)`: a `fit` resumed at
  epoch 1 ends bitwise equal to two uninterrupted epochs (NAG and SGD
  with momentum, whose states carry across; with the updater on the
  Module and on a `device` store); the `.states` file is written, and
  a resume without it differs.  `load_latest` raises and names A17.
* The iterators give the JAX package's batches (data, label, pad):
  `NDArrayIter` with `roll_over` (in order, and shuffled from the same
  numpy seed), `SimpleIter`, `ResizeIter`, `CSVIter` (with and without
  `round_batch`), `io.create`, and `PrefetchingIter` over two
  iterators with renamed inputs, over two epochs; its producer threads
  are joined at `reset` and `close` and found dead.
"""
import threading

import numpy as np
import pytest
import torch

import mxtpu as jmx
import mxtpu_torch as tmx
from mxtpu_torch import context as tcontext
from mxtpu_torch.base import MXNetError

torch.set_num_threads(1)


def _mlp(mx):
    x = mx.sym.Variable("data")
    h = mx.sym.Activation(mx.sym.FullyConnected(x, num_hidden=8, name="fc1"),
                          act_type="tanh")
    h = mx.sym.FullyConnected(h, num_hidden=3, name="fc2")
    return mx.sym.SoftmaxOutput(h, mx.sym.Variable("softmax_label"),
                                name="softmax")


def _data():
    rng = np.random.RandomState(0)
    return (rng.randn(24, 5).astype(np.float32),
            rng.randint(0, 3, 24).astype(np.float32))


def _params():
    rng = np.random.RandomState(1)
    return {"fc1_weight": rng.randn(8, 5).astype(np.float32) * 0.5,
            "fc1_bias": np.zeros(8, np.float32),
            "fc2_weight": rng.randn(3, 8).astype(np.float32) * 0.5,
            "fc2_bias": np.zeros(3, np.float32)}


def _fit(mod, kvstore, optimizer, begin, end, params=None):
    x, y = _data()
    it = tmx.io.NDArrayIter(x, y, batch_size=6, ctx=tmx.cpu())
    store = tmx.kv.create("device") if kvstore == "device" else kvstore
    mod.fit(it, num_epoch=end, begin_epoch=begin, kvstore=store,
            optimizer=optimizer, optimizer_params={
                "learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3},
            arg_params=None if params is None else {
                k: tmx.nd.array(v, ctx=tmx.cpu()) for k, v in params.items()},
            aux_params={} if params is not None else None)
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


@pytest.mark.parametrize("optimizer,kvstore", [("nag", "local"),
                                               ("nag", "device"),
                                               ("sgd", "local")])
def test_resumed_fit_equals_the_uninterrupted_one(optimizer, kvstore,
                                                  tmp_path, monkeypatch):
    # the store is made on the default device
    monkeypatch.setattr(tcontext, "default_ctx", lambda: torch.device("cpu"))
    prefix = str(tmp_path / "mlp")
    whole = _fit(tmx.mod.Module(_mlp(tmx), context=tmx.cpu()), kvstore,
                 optimizer, 0, 2, _params())
    first = tmx.mod.Module(_mlp(tmx), context=tmx.cpu())
    _fit(first, kvstore, optimizer, 0, 1, _params())
    first.save_checkpoint(prefix, 1, save_optimizer_states=True)
    assert (tmp_path / "mlp-0001.states").exists()
    resumed = tmx.mod.Module.load(prefix, 1, load_optimizer_states=True,
                                  context=tmx.cpu())
    got = _fit(resumed, kvstore, optimizer, 1, 2)
    for k in whole:
        np.testing.assert_array_equal(got[k], whole[k])
    cold = tmx.mod.Module.load(prefix, 1, context=tmx.cpu())
    fresh = _fit(cold, kvstore, optimizer, 1, 2)
    assert any(not np.array_equal(fresh[k], whole[k]) for k in whole)


def test_optimizer_state_files_and_load_latest(tmp_path):
    mod = tmx.mod.Module(_mlp(tmx), context=tmx.cpu())
    _fit(mod, "local", "nag", 0, 1, _params())
    path = str(tmp_path / "opt.states")
    mod.save_optimizer_states(path)
    before = {i: s.asnumpy() for i, s in mod._updater.states.items()}
    for s in mod._updater.states.values():
        s[:] = 0
    mod.load_optimizer_states(path)
    for i, s in mod._updater.states.items():
        np.testing.assert_array_equal(s.asnumpy(), before[i])
    with pytest.raises(MXNetError, match="A17"):
        tmx.mod.Module.load_latest(str(tmp_path / "mlp"))


def _batches(it, epochs=2):
    out = []
    for _ in range(epochs):
        for b in it:
            out.append(([d.asnumpy() for d in b.data],
                        [lb.asnumpy() for lb in (b.label or [])], b.pad))
        it.reset()
    return out


def _same_batches(t, j):
    assert len(t) == len(j) > 0
    for (td, tl, tp), (jd, jl, jp) in zip(t, j):
        assert (tp or 0) == (jp or 0)
        for a, b in zip(td + tl, jd + jl):
            np.testing.assert_array_equal(a, b)


def _iter_pair(make):
    return make(tmx, dict(ctx=tmx.cpu())), make(jmx, {})


@pytest.mark.parametrize("shuffle", [False, True])
def test_ndarray_iter_roll_over_matches_the_reference(shuffle):
    x = np.arange(40, dtype=np.float32).reshape(10, 4)
    y = np.arange(10, dtype=np.float32)
    out = []
    for mx, kw in ((tmx, dict(ctx=tmx.cpu())), (jmx, {})):
        np.random.seed(3)
        it = mx.io.NDArrayIter(x, y, batch_size=4, shuffle=shuffle,
                               last_batch_handle="roll_over", **kw)
        out.append(_batches(it, epochs=3))
    _same_batches(*out)
    assert [b[2] for b in out[0]][:4] == [0, 0, 2, 0]


def test_simple_and_resize_iters_match_the_reference():
    def gen(i):
        rng = np.random.RandomState(i)
        return [rng.rand(2, 3).astype(np.float32)], \
            [rng.rand(2).astype(np.float32)]

    def simple(mx, kw):
        return mx.io.SimpleIter([mx.io.DataDesc("data", (2, 3))],
                                [mx.io.DataDesc("softmax_label", (2,))],
                                gen, 3, **kw)

    _same_batches(*[_batches(it) for it in _iter_pair(simple)])

    def resized(mx, kw):
        x = np.arange(30, dtype=np.float32).reshape(10, 3)
        return mx.io.ResizeIter(mx.io.NDArrayIter(x, batch_size=4, **kw), 5)

    t, j = [_batches(it) for it in _iter_pair(resized)]
    assert len(t) == 10
    _same_batches(t, j)


@pytest.mark.parametrize("round_batch", [True, False])
def test_csv_iter_and_create_match_the_reference(round_batch, tmp_path):
    rng = np.random.RandomState(2)
    data = str(tmp_path / "d.csv")
    label = str(tmp_path / "l.csv")
    np.savetxt(data, rng.rand(7, 6), delimiter=",", fmt="%.6f")
    np.savetxt(label, rng.randint(0, 3, (7, 1)), delimiter=",", fmt="%d")

    def csv(mx, kw):
        return mx.io.create("CSVIter", data_csv=data, data_shape=(2, 3),
                            label_csv=label, batch_size=3,
                            round_batch=round_batch, **kw)

    t, j = [_batches(it) for it in _iter_pair(csv)]
    assert len(t) == (6 if round_batch else 4)
    _same_batches(t, j)
    with pytest.raises(MXNetError):
        tmx.io.create("NoSuchIter")


def _prefetch_threads():
    return [th for th in threading.enumerate()
            if th.name == "PrefetchingIter"]


def test_prefetching_iter_matches_the_reference_and_joins_its_threads():
    x = np.arange(60, dtype=np.float32).reshape(15, 4)
    y = np.arange(15, dtype=np.float32)

    def prefetch(mx, kw):
        return mx.io.PrefetchingIter(
            [mx.io.NDArrayIter(x, y, batch_size=4, **kw),
             mx.io.NDArrayIter(x * 2, y + 1, batch_size=4,
                               data_name="d2", label_name="l2", **kw)],
            rename_data=[{"data": "a"}, {"d2": "b"}])

    # the port's producer tasks run on a threaded engine of the test's
    # own, whose worker threads are joined at its close
    eng = tmx.engine.ThreadedEngine(num_threads=2)
    prev = tmx.engine._engine
    tmx.engine.set_engine(eng)
    try:
        t, j = _iter_pair(prefetch)
        assert [d.name for d in t.provide_data] == ["a", "b"] == \
            [d.name for d in j.provide_data]
        assert t._engine is eng
        _same_batches(_batches(t), _batches(j))
        t.reset()
        _same_batches(_batches(t), _batches(j))
        t.close()
        assert t._queue.empty()
        eng.wait_for_all()
        assert eng.num_outstanding() == 0
    finally:
        tmx.engine.set_engine(prev)
        eng.close()
    assert _prefetch_threads() == []


def test_prefetching_iter_raises_the_producers_error():
    class Broken(tmx.io.DataIter):
        batch_size = 1
        provide_data = provide_label = []

        def next(self):
            raise RuntimeError("broken source")

    it = tmx.io.PrefetchingIter(Broken())
    with pytest.raises(RuntimeError, match="broken source"):
        next(it)
    it.close()
    assert _prefetch_threads() == []
