"""The PyTorch port's one-process KVStore against the JAX package's, on
the CPU: ``init``/``push``/``pull``/``pushpull`` of one key and of key
lists, several values a push (summed), the updater and the optimizer
on the store, 2-bit compression with its residual, the row-sparse merge
(two pushes of one key sum to their dense sum; with an optimizer the
update stays lazy), ``row_sparse_pull`` into a row-sparse output
(exactly the requested rows) and into a dense one (zeros elsewhere),
the save and load of optimizer states.  ``dist_*`` and ``tpu`` raise.

Tolerance: ``EXACT`` (1e-6 absolute): both compute the same float32
sums and updates.
"""
import numpy as np
import pytest

import mxtpu as jmx
import mxtpu_torch as tmx
from mxtpu_torch.base import MXNetError
from mxtpu_torch.ndarray import sparse as tsp
import torch

torch.set_num_threads(1)

CPU = tmx.cpu()
SHAPE = (4, 4)
KEYS = [5, 7, 11]
EXACT = dict(rtol=0, atol=1e-6)


def _store(kind="local", mx=tmx):
    kv = mx.kv.create(kind, ctx=CPU) if mx is tmx else mx.kv.create(kind)
    return kv


def _arr(mx, a):
    return mx.nd.array(np.asarray(a, np.float32), ctx=mx.cpu())


def _pull(kv, mx, key, shape=SHAPE):
    out = mx.nd.zeros(shape, ctx=mx.cpu())
    kv.pull(key, out=out)
    return out.asnumpy()


@pytest.mark.parametrize("kind", ["local", "device"])
def test_push_pull_one_key_and_lists(kind):
    kv = _store(kind)
    assert kv.type == kind and kv.rank == 0 and kv.num_workers == 1
    kv.init(3, _arr(tmx, np.zeros(SHAPE)))
    kv.init(KEYS, [_arr(tmx, np.zeros(SHAPE))] * len(KEYS))
    kv.push(3, _arr(tmx, np.ones(SHAPE)))
    np.testing.assert_array_equal(_pull(kv, tmx, 3), np.ones(SHAPE))
    kv.push(KEYS, [_arr(tmx, np.full(SHAPE, 4.0))] * len(KEYS))
    outs = [tmx.nd.zeros(SHAPE, ctx=CPU) for _ in KEYS]
    kv.pull(KEYS, out=outs)
    for o in outs:
        np.testing.assert_array_equal(o.asnumpy(), np.full(SHAPE, 4.0))
    with pytest.raises(MXNetError, match="already initialized"):
        kv.init(3, _arr(tmx, np.zeros(SHAPE)))
    with pytest.raises(MXNetError, match="not initialized"):
        kv.push(99, _arr(tmx, np.zeros(SHAPE)))


def test_several_values_a_push_sum_and_pushpull():
    kv = _store("device")
    kv.init("w", _arr(tmx, np.zeros(SHAPE)))
    kv.push("w", [_arr(tmx, np.full(SHAPE, i + 1.0)) for i in range(4)])
    outs = [tmx.nd.zeros(SHAPE, ctx=CPU) for _ in range(2)]
    kv.pull("w", out=outs)
    for o in outs:
        np.testing.assert_array_equal(o.asnumpy(), np.full(SHAPE, 10.0))
    v = _arr(tmx, np.full(SHAPE, 2.0))
    kv.pushpull("w", v)
    np.testing.assert_array_equal(v.asnumpy(), np.full(SHAPE, 2.0))


def test_updater_runs_on_push():
    kv = _store()
    kv.init(3, _arr(tmx, np.zeros(SHAPE)))
    kv.set_updater(lambda key, recv, stored: stored.__iadd__(recv * 2))
    for _ in range(4):
        kv.push(3, _arr(tmx, np.ones(SHAPE)))
    np.testing.assert_array_equal(_pull(kv, tmx, 3), np.full(SHAPE, 8.0))


def test_two_bit_compression_matches_mxtpu():
    rng = np.random.RandomState(0)
    grads = [rng.uniform(-1.2, 1.2, SHAPE).astype(np.float32)
             for _ in range(4)]
    seen = []
    for mx in (tmx, jmx):
        kv = _store("local", mx)
        kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
        kv.init(3, _arr(mx, np.zeros(SHAPE)))
        steps = []
        for g in grads:
            kv.push(3, _arr(mx, g))
            steps.append(_pull(kv, mx, 3))
        seen.append(steps)
    residual = np.zeros(SHAPE, np.float32)
    for t, j, g in zip(seen[0], seen[1], grads):
        x = g + residual
        expect = np.where(x > 0.5, 0.5, np.where(x < -0.5, -0.5, 0.0))
        residual = x - expect
        np.testing.assert_array_equal(t, j)
        np.testing.assert_allclose(t, expect, **EXACT)
    with pytest.raises(MXNetError, match="unsupported compression"):
        _store().set_gradient_compression({"type": "1bit"})


@pytest.mark.parametrize("opt", [dict(name="sgd", learning_rate=0.1,
                                      momentum=0.9),
                                 dict(name="adagrad", learning_rate=0.1)],
                         ids=["sgd_momentum", "adagrad"])
def test_optimizer_on_the_store_matches_mxtpu(opt):
    rng = np.random.RandomState(1)
    w0 = rng.randn(*SHAPE).astype(np.float32)
    grads = [rng.randn(*SHAPE).astype(np.float32) for _ in range(3)]
    res = []
    for mx in (tmx, jmx):
        kv = _store("local", mx)
        kw = dict(opt)
        kv.set_optimizer(mx.optimizer.create(kw.pop("name"), **kw))
        kv.init(3, _arr(mx, w0))
        for g in grads:
            kv.push(3, _arr(mx, g))
        res.append(_pull(kv, mx, 3))
    np.testing.assert_allclose(res[0], res[1], **EXACT)


def _rsp(mx, sp, rows, value, shape=(8, 2)):
    data = np.full((len(rows), shape[1]), value, np.float32)
    return sp.row_sparse_array((data, np.asarray(rows)), shape=shape,
                               ctx=mx.cpu())


def test_row_sparse_pushes_merge_to_their_dense_sum():
    res = []
    for mx, sp in ((tmx, tsp), (jmx, jmx.nd.sparse)):
        kv = _store("local", mx)
        kv.init("w", _arr(mx, np.ones((8, 2))))
        kv.push("w", [_rsp(mx, sp, [1, 4], 2.0), _rsp(mx, sp, [4, 6], 3.0)])
        res.append(_pull(kv, mx, "w", (8, 2)))
    expect = np.zeros((8, 2), np.float32)
    expect[1], expect[4], expect[6] = 2.0, 5.0, 3.0
    np.testing.assert_array_equal(res[0], expect)
    np.testing.assert_array_equal(res[0], res[1])
    merged = tsp.add(_rsp(tmx, tsp, [1, 4], 2.0), _rsp(tmx, tsp, [4, 6], 3.0))
    assert merged.indices.asnumpy().tolist() == [1, 4, 6]


def test_row_sparse_push_updates_lazily_on_the_store():
    res = []
    for mx, sp in ((tmx, tsp), (jmx, jmx.nd.sparse)):
        kv = _store("local", mx)
        kv.set_optimizer(mx.optimizer.create("sgd", learning_rate=1.0,
                                             wd=0.1))
        w0 = np.arange(16, dtype=np.float32).reshape(8, 2)
        kv.init("w", _arr(mx, w0))
        kv.push("w", [_rsp(mx, sp, [1], 2.0), _rsp(mx, sp, [1, 5], 3.0)])
        res.append(_pull(kv, mx, "w", (8, 2)))
    np.testing.assert_allclose(res[0], res[1], **EXACT)
    untouched = [0, 2, 3, 4, 6, 7]
    np.testing.assert_array_equal(
        res[0][untouched], np.arange(16, dtype=np.float32).reshape(8, 2)[
            untouched])
    with pytest.raises(MXNetError, match="mixed sparse/dense"):
        kv = _store()
        kv.init("w", _arr(tmx, np.ones((8, 2))))
        kv.push("w", [_rsp(tmx, tsp, [1], 1.0), _arr(tmx, np.ones((8, 2)))])


@pytest.mark.parametrize("target", ["row_sparse", "default"])
def test_row_sparse_pull_matches_mxtpu(target):
    w = np.random.RandomState(9).randn(8, 3).astype(np.float32)
    rows = np.array([4, 1, 4, 6], np.float32)
    outs = []
    for mx, sp in ((tmx, tsp), (jmx, jmx.nd.sparse)):
        kv = _store("device", mx)
        kv.init(3, _arr(mx, w))
        out = sp.zeros(target, (8, 3), ctx=mx.cpu()) if target != "default" \
            else _arr(mx, np.full((8, 3), 7.0))
        kv.row_sparse_pull(3, out=out, row_ids=_arr(mx, rows))
        outs.append(out)
    t, j = outs
    expect = np.zeros_like(w)
    expect[[1, 4, 6]] = w[[1, 4, 6]]
    np.testing.assert_array_equal(t.asnumpy(), expect)
    np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())
    if target == "row_sparse":
        assert t.indices.asnumpy().tolist() == [1, 4, 6]
        assert t.data.shape == (3, 3)
    kv = _store()
    kv.init(3, _arr(tmx, w))
    with pytest.raises(MXNetError, match="out of range"):
        kv.row_sparse_pull(3, out=tsp.zeros("row_sparse", (8, 3), ctx=CPU),
                           row_ids=_arr(tmx, [2, 8]))
    with pytest.raises(MXNetError, match="row_sparse_pull"):
        kv.pull(3, out=tsp.zeros("row_sparse", (8, 3), ctx=CPU))


def test_save_and_load_optimizer_states(tmp_path):
    kv = _store()
    kv.set_optimizer(tmx.optimizer.create("sgd", learning_rate=0.1,
                                          momentum=0.9))
    kv.init(3, _arr(tmx, np.zeros(SHAPE)))
    for _ in range(3):
        kv.push(3, _arr(tmx, np.ones(SHAPE)))
    fname = str(tmp_path / "opt.states")
    kv.save_optimizer_states(fname, dump_optimizer=True)
    kv2 = _store()
    kv2.set_optimizer(tmx.optimizer.create("sgd", learning_rate=0.1,
                                           momentum=0.9))
    kv2.load_optimizer_states(fname)
    st1, st2 = kv._updater.states, kv2._updater.states
    assert set(st1) == set(st2) == {3}
    np.testing.assert_array_equal(st1[3].asnumpy(), st2[3].asnumpy())
    assert st2[3].ctx == CPU
    assert kv2._optimizer.num_update == kv._optimizer.num_update == 3
    with pytest.raises(MXNetError, match="updater"):
        _store().save_optimizer_states(fname)


@pytest.mark.parametrize("name", ["dist_sync", "dist_async", "tpu"])
def test_distributed_and_tpu_stores_raise(name, monkeypatch):
    """``tpu`` is not ported (A15b); the distributed stores are
    (test_torch_dist_kvstore.py) but raise, naming A17, where a setting
    asks for server replication."""
    monkeypatch.setenv("MXTPU_PS_REPLICATION", "1")
    with pytest.raises(MXNetError, match="A15b" if name == "tpu" else "A17"):
        tmx.kv.create(name, ctx=CPU)
    with pytest.raises(MXNetError, match="unknown kvstore"):
        tmx.kv.create("ring", ctx=CPU)
