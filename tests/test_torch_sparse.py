"""The PyTorch port's sparse arrays against the JAX package's, on the CPU.

* The CSR and row-sparse constructors, ``cast_storage`` between every
  pair of storage types, ``dot`` in every form (a vector on the dense
  side too, and the densified fallback), ``retain``, ``add``, ``zeros``;
  the ops the linear classifier needs (``one_hot``,
  ``_sparse_adagrad_update``, the graph forms of ``cast_storage`` and
  ``_sparse_retain``).
* Row-sparse gradients: of ``csr · W`` and of
  ``Embedding(sparse_grad=True)`` with duplicate and out-of-range ids,
  two lookups of one table, a dense leaf, a hybridized gluon
  ``Embedding``.  The JAX package pads its gradients' ids with the
  out-of-range id ``n_rows``; the port stores sorted, unique, in-range
  ids only.  So the checks compare densified values and the sets of
  in-range ids, never the stored length.
* The lazy updates (SGD with momentum 0 and 0.9, clip and weight
  decay; AdaGrad) for 1 and 3 steps against the JAX package's, and
  every row the gradient does not name bitwise unchanged.

Index arrays are int64 in the port and int32 in the JAX package:
values are compared, not dtypes.  Tolerances: ``EXACT`` (1e-6
absolute) where both compute the same float32 expression; ``SUM``
(rtol 1e-5, atol 1e-5) for products, whose sums run in other orders.
"""
import numpy as np
import pytest
import torch

import mxtpu as jmx
import mxtpu_torch as tmx
from mxtpu_torch.base import MXNetError
from mxtpu_torch.ndarray import sparse as tsp

torch.set_num_threads(1)

jsp = jmx.nd.sparse
CPU = tmx.cpu()
EXACT = dict(rtol=0, atol=1e-6)
SUM = dict(rtol=1e-5, atol=1e-5)


def _dense_with_zero_rows(m, n, frac=0.5, seed=0):
    rng = np.random.RandomState(seed)
    a = rng.randn(m, n).astype(np.float32)
    a[rng.choice(m, int(m * frac), replace=False)] = 0
    a[np.abs(a) < 0.6] = 0
    return a


def _tnd(a):
    return tmx.nd.array(a, ctx=CPU)


def _in_range(ids, n):
    return sorted(int(i) for i in np.asarray(ids) if i < n)


# ---------------------------------------------------------------------------
# Arrays
# ---------------------------------------------------------------------------

def test_csr_constructors_match_mxtpu():
    a = _dense_with_zero_rows(8, 5)
    t, j = tsp.csr_matrix(_tnd(a)), jsp.csr_matrix(jmx.nd.array(a))
    assert t.stype == "csr" and t.shape == (8, 5) and t.nnz == j.nnz
    np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())
    np.testing.assert_array_equal(t.indptr.asnumpy(), j.indptr.asnumpy())
    np.testing.assert_array_equal(t.indices.asnumpy(), j.indices.asnumpy())
    np.testing.assert_array_equal(t._indptr_host, j.indptr.asnumpy())
    parts = ([1.0, 2.0, 3.0], [0, 2, 1], [0, 1, 2, 2, 3])
    t = tsp.csr_matrix(parts, shape=(4, 3), ctx=CPU)
    j = jsp.csr_matrix(parts, shape=(4, 3))
    np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())
    assert t.nnz == 3 and t.indices._data.dtype == torch.int64


def test_row_sparse_constructors_match_mxtpu():
    a = _dense_with_zero_rows(10, 4, seed=1)
    t, j = tsp.row_sparse_array(_tnd(a)), jsp.row_sparse_array(
        jmx.nd.array(a))
    np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())
    np.testing.assert_array_equal(t.indices.asnumpy(), j.indices.asnumpy())
    # from parts: unsorted ids are sorted with their rows
    rows = np.arange(6, dtype=np.float32).reshape(3, 2)
    t = tsp.row_sparse_array((rows, [7, 1, 4]), shape=(9, 2), ctx=CPU)
    np.testing.assert_array_equal(t.indices.asnumpy(), [1, 4, 7])
    expect = np.zeros((9, 2), np.float32)
    expect[[7, 1, 4]] = rows
    np.testing.assert_array_equal(t.asnumpy(), expect)


@pytest.mark.parametrize("src,dst", [
    ("default", "csr"), ("default", "row_sparse"), ("csr", "default"),
    ("row_sparse", "default"), ("csr", "row_sparse"), ("row_sparse", "csr")])
def test_cast_storage_pairs_match_mxtpu(src, dst):
    a = _dense_with_zero_rows(6, 3, seed=2)
    t, j = _tnd(a).tostype(src), jmx.nd.array(a).tostype(src)
    tt, jj = t.tostype(dst), j.tostype(dst)
    assert tt.stype == dst == jj.stype
    np.testing.assert_array_equal(tt.asnumpy(), jj.asnumpy())
    np.testing.assert_array_equal(tt.asnumpy(), a)
    if dst != "default":
        np.testing.assert_array_equal(tt.indices.asnumpy(),
                                      jj.indices.asnumpy())


def test_zeros_and_empty_arrays():
    for stype in ("csr", "row_sparse", "default"):
        t = tsp.zeros(stype, (4, 5), ctx=CPU)
        j = jsp.zeros(stype, (4, 5))
        assert t.stype == stype and t.shape == (4, 5)
        np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())
    assert tsp.zeros("csr", (4, 5), ctx=CPU).nnz == 0
    with pytest.raises(MXNetError, match="unknown stype"):
        tsp.zeros("coo", (2, 2), ctx=CPU)


def test_constructors_reject_ids_out_of_range():
    with pytest.raises(MXNetError, match="out of range"):
        tsp.csr_matrix(([1.0], [5], [0, 1]), shape=(1, 5), ctx=CPU)
    with pytest.raises(MXNetError, match="inconsistent"):
        tsp.csr_matrix(([1.0], [0], [0, 2]), shape=(1, 5), ctx=CPU)
    with pytest.raises(MXNetError, match="out of range"):
        tsp.row_sparse_array((np.ones((1, 2)), [3]), shape=(3, 2), ctx=CPU)
    with pytest.raises(MXNetError, match="duplicate"):
        tsp.row_sparse_array((np.ones((2, 2)), [1, 1]), shape=(3, 2),
                             ctx=CPU)


def _dot_case(form):
    """(port result, mxtpu result, numpy result) of one dot form."""
    rng = np.random.RandomState(3)
    a = _dense_with_zero_rows(8, 6, seed=4)
    tc, jc = tsp.csr_matrix(_tnd(a)), jsp.csr_matrix(jmx.nd.array(a))

    def both(x):
        return _tnd(x), jmx.nd.array(x)

    if form == "csr.W":
        w = rng.randn(6, 4).astype(np.float32)
        tw, jw = both(w)
        return tsp.dot(tc, tw), jsp.dot(jc, jw), a @ w
    if form == "csrT.W":
        w = rng.randn(8, 4).astype(np.float32)
        tw, jw = both(w)
        return (tsp.dot(tc, tw, transpose_a=True),
                jsp.dot(jc, jw, transpose_a=True), a.T @ w)
    if form == "D.csr":
        d = rng.randn(3, 8).astype(np.float32)
        td, jd = both(d)
        return tsp.dot(td, tc), jsp.dot(jd, jc), d @ a
    if form == "D.csrT":
        d = rng.randn(3, 6).astype(np.float32)
        td, jd = both(d)
        return (tsp.dot(td, tc, transpose_b=True),
                jsp.dot(jd, jc, transpose_b=True), d @ a.T)
    if form == "DT.csr":
        d = rng.randn(8, 3).astype(np.float32)
        td, jd = both(d)
        return (tsp.dot(td, tc, transpose_a=True),
                jsp.dot(jd, jc, transpose_a=True), d.T @ a)
    if form == "csr.v":
        v = rng.randn(6).astype(np.float32)
        tv, jv = both(v)
        return tsp.dot(tc, tv), jsp.dot(jc, jv), a @ v
    if form == "csrT.v":
        v = rng.randn(8).astype(np.float32)
        tv, jv = both(v)
        return (tsp.dot(tc, tv, transpose_a=True),
                jsp.dot(jc, jv, transpose_a=True), a.T @ v)
    if form == "v.csr":
        v = rng.randn(8).astype(np.float32)
        tv, jv = both(v)
        return tsp.dot(tv, tc), jsp.dot(jv, jc), v @ a
    assert form == "rsp.W (densified)"
    w = rng.randn(6, 4).astype(np.float32)
    tw, jw = both(w)
    tr, jr = tsp.row_sparse_array(_tnd(a)), jsp.row_sparse_array(
        jmx.nd.array(a))
    return tsp.dot(tr, tw), jsp.dot(jr, jw), a @ w


@pytest.mark.parametrize("form", ["csr.W", "csrT.W", "D.csr", "D.csrT",
                                  "DT.csr", "csr.v", "csrT.v", "v.csr",
                                  "rsp.W (densified)"])
def test_dot_forms_match_mxtpu(form):
    t, j, ref = _dot_case(form)
    assert t.shape == j.shape == ref.shape
    np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), **SUM)
    np.testing.assert_allclose(t.asnumpy(), ref, **SUM)


def test_retain_and_add_match_mxtpu():
    a = _dense_with_zero_rows(10, 3, seed=5)
    b = _dense_with_zero_rows(10, 3, seed=6)
    ta, tb = tsp.row_sparse_array(_tnd(a)), tsp.row_sparse_array(_tnd(b))
    ja, jb = jsp.row_sparse_array(jmx.nd.array(a)), jsp.row_sparse_array(
        jmx.nd.array(b))
    keep = np.array([0, 3, 7, 3, 9], np.float32)
    tr, jr = tsp.retain(ta, _tnd(keep)), jsp.retain(ja, jmx.nd.array(keep))
    np.testing.assert_array_equal(tr.asnumpy(), jr.asnumpy())
    np.testing.assert_array_equal(tr.indices.asnumpy(), jr.indices.asnumpy())
    assert ta.retain(_tnd(np.zeros(0))).indices.shape == (0,)
    ts, js = tsp.add(ta, tb), jsp.add(ja, jb)
    assert ts.stype == "row_sparse"
    np.testing.assert_array_equal(ts.indices.asnumpy(), js.indices.asnumpy())
    np.testing.assert_allclose(ts.asnumpy(), js.asnumpy(), **EXACT)
    np.testing.assert_allclose(tsp.add(ta, _tnd(b)).asnumpy(), a + b,
                               **EXACT)


@pytest.mark.parametrize("target", ["row_sparse", "default"])
def test_row_writes_match_mxtpu(target):
    """retain_rows_into (row_sparse_pull's gather) and set_rows_into
    (rows already gathered, unsorted) into both kinds of output."""
    src = np.random.RandomState(13).randn(9, 2).astype(np.float32)
    ids = np.array([6, 2, 6, 0], np.float32)
    rows, data = np.array([5, 1], np.int64), src[[5, 1]]
    for fill in ("retain_rows_into", "set_rows_into"):
        outs = []
        for mx, sp, arr in ((tmx, tsp, _tnd), (jmx, jsp, jmx.nd.array)):
            dst = sp.zeros(target, (9, 2), ctx=mx.cpu()) \
                if target != "default" else arr(np.ones((9, 2), np.float32))
            if fill == "retain_rows_into":
                sp.retain_rows_into(arr(src), arr(ids), dst)
            else:
                sp.set_rows_into(rows, data, dst)
            outs.append(dst.asnumpy())
        np.testing.assert_array_equal(outs[0], outs[1])


# ---------------------------------------------------------------------------
# Ops
# ---------------------------------------------------------------------------

def test_one_hot_and_storage_ops_match_mxtpu():
    lab = np.array([1, 0, 3, -1, 2], np.float32)  # 3 and -1 off the range
    np.testing.assert_array_equal(
        tmx.nd.one_hot(_tnd(lab), depth=3, on_value=2.0,
                       off_value=-1.0).asnumpy(),
        jmx.nd.one_hot(jmx.nd.array(lab), depth=3, on_value=2.0,
                       off_value=-1.0).asnumpy())
    x = np.random.RandomState(7).randn(6, 2).astype(np.float32)
    ids = np.array([4, 1, 9], np.float32)
    np.testing.assert_array_equal(
        tmx.nd._sparse_retain(_tnd(x), _tnd(ids)).asnumpy(),
        jmx.nd._sparse_retain(jmx.nd.array(x), jmx.nd.array(ids)).asnumpy())
    np.testing.assert_array_equal(
        tmx.nd.cast_storage(_tnd(x), stype="row_sparse").asnumpy(), x)


def test_dense_adagrad_op_matches_mxtpu():
    rng = np.random.RandomState(8)
    w, g, h = (rng.randn(5, 3).astype(np.float32) for _ in range(3))
    h = np.abs(h)
    kw = dict(lr=0.1, epsilon=1e-7, wd=0.01, rescale_grad=0.5,
              clip_gradient=0.3)
    for name in ("_sparse_adagrad_update", "adagrad_update"):
        t = getattr(tmx.nd, name)(_tnd(w), _tnd(g), _tnd(h), **kw)
        j = getattr(jmx.nd, name)(jmx.nd.array(w), jmx.nd.array(g),
                                  jmx.nd.array(h), **kw)
        for a, b in zip(t, j):
            np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), **EXACT)


# ---------------------------------------------------------------------------
# Row-sparse gradients
# ---------------------------------------------------------------------------

def _csr_dot_grads(stype):
    rng = np.random.RandomState(9)
    x = (rng.rand(8, 30) < 0.15).astype(np.float32) * rng.rand(8, 30)
    x = x.astype(np.float32)
    wv = rng.randn(30, 4).astype(np.float32)
    og = rng.randn(8, 4).astype(np.float32)
    out = []
    for mx, sp, arr in ((tmx, tsp, _tnd), (jmx, jsp, jmx.nd.array)):
        w = arr(wv)
        w.attach_grad(stype=stype)
        with mx.autograd.record():
            y = sp.dot(sp.csr_matrix(arr(x)), w)
        y.backward(arr(og))
        out.append(w.grad)
    return out + [x.T @ og, sorted(np.nonzero(x.sum(0))[0].tolist())]


def test_csr_dot_row_sparse_grad_matches_mxtpu():
    t, j, ref, touched = _csr_dot_grads("row_sparse")
    assert t.stype == "row_sparse" == j.stype
    np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), **SUM)
    np.testing.assert_allclose(t.asnumpy(), ref, **SUM)
    ids = t.indices.asnumpy()
    assert ids.tolist() == touched == _in_range(j.indices.asnumpy(), 30)
    assert t.data.shape == (len(touched), 4)


def test_csr_dot_dense_leaf_gets_densified_grad():
    t, j, ref, _ = _csr_dot_grads(None)
    assert t.stype == "default"
    np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), **SUM)
    np.testing.assert_allclose(t.asnumpy(), ref, **SUM)


def _embedding_grads(id_lists, vocab=40, dim=6, stype="row_sparse",
                     sparse_grad=True):
    wv = np.random.RandomState(10).randn(vocab, dim).astype(np.float32)
    out = []
    for mx, arr in ((tmx, _tnd), (jmx, jmx.nd.array)):
        w = arr(wv)
        w.attach_grad(stype=stype)
        with mx.autograd.record():
            loss = None
            for k, ids in enumerate(id_lists):
                e = mx.nd.Embedding(arr(np.asarray(ids, np.float32)), w,
                                    input_dim=vocab, output_dim=dim,
                                    sparse_grad=sparse_grad)
                term = (e * e).sum() if k == 0 else (e * 3).sum()
                loss = term if loss is None else loss + term
        loss.backward()
        out.append(w.grad)
    return out


@pytest.mark.parametrize("id_lists", [
    [[3, 7, 3, 9, 39]],                 # duplicates
    [[-1.0, 3.0, 40.0, 39.0, 2.7]],     # out of range: clipped to 0 and 39
    [[1, 5, 7], [5, 9]],                # two lookups of one table
], ids=["duplicates", "out_of_range", "two_lookups"])
def test_embedding_sparse_grad_matches_mxtpu(id_lists):
    t, j = _embedding_grads(id_lists)
    assert isinstance(t, tsp.RowSparseNDArray)
    np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), **EXACT)
    ids = t.indices.asnumpy()
    assert ids.tolist() == _in_range(j.indices.asnumpy(), 40)
    assert np.all(np.diff(ids) > 0) and ids.min() >= 0 and ids.max() < 40
    dense_t, _ = _embedding_grads(id_lists, stype=None, sparse_grad=False)
    np.testing.assert_allclose(t.asnumpy(), dense_t.asnumpy(), **EXACT)


def test_embedding_sparse_grad_into_a_dense_leaf():
    t, j = _embedding_grads([[3, 7, 3]], stype=None)
    assert t.stype == "default"
    np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), **EXACT)


def test_row_sparse_grad_refuses_grad_req_add():
    w = _tnd(np.ones((5, 2), np.float32))
    w.attach_grad(grad_req="add", stype="row_sparse")
    with tmx.autograd.record():
        loss = tmx.nd.Embedding(_tnd(np.array([1.0])), w, input_dim=5,
                                output_dim=2, sparse_grad=True).sum()
    with pytest.raises(MXNetError, match="grad_req='add'"):
        loss.backward()


@pytest.mark.parametrize("hybridize", [False, True])
def test_gluon_sparse_embedding_matches_mxtpu(hybridize):
    """Not hybridized, the lookup's rows; hybridized, the traced op's
    dense gradient cast to the rows holding a non-zero, in both
    packages (row 4 is looked up with a zero cotangent)."""
    wv = np.random.RandomState(11).randn(20, 3).astype(np.float32)
    x = np.array([[1, 5, 5], [7, 19, 4]], np.float32)
    grads = []
    for mx, arr in ((tmx, _tnd), (jmx, jmx.nd.array)):
        with mx.sym.NameManager():
            net = mx.gluon.nn.Embedding(20, 3, sparse_grad=True)
        net.initialize(ctx=mx.cpu())
        net.weight.set_data(arr(wv))
        if hybridize:
            net.hybridize()
        mask = arr(np.array([[1, 1, 1], [1, 1, 0]], np.float32)
                   .reshape(2, 3, 1))
        with mx.autograd.record():
            y = net(arr(x))
            loss = (y * y * mask).sum()
        loss.backward()
        grads.append(net.weight.grad())
    t, j = grads
    assert t.stype == "row_sparse" == j.stype
    np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), **EXACT)
    assert t.indices.asnumpy().tolist() == _in_range(j.indices.asnumpy(), 20)
    assert (4 in t.indices.asnumpy().tolist()) == (not hybridize)


# ---------------------------------------------------------------------------
# Lazy updates
# ---------------------------------------------------------------------------

def _lazy_run(name, steps, **opt_kw):
    """``steps`` updates of a (12, 3) weight by row-sparse gradients in
    both packages; returns each step's (weight, state) pairs and the
    weight before."""
    rng = np.random.RandomState(12)
    w0 = rng.randn(12, 3).astype(np.float32)
    grads = []
    for _ in range(steps):
        rows = np.sort(rng.choice(12, 4, replace=False))
        grads.append((rng.randn(4, 3).astype(np.float32), rows))
    runs = []
    for mx, sp, arr in ((tmx, tsp, _tnd), (jmx, jsp, jmx.nd.array)):
        opt = mx.optimizer.create(name, **opt_kw)
        w = arr(w0)
        state = opt.create_state(0, w)
        trace = []
        for data, rows in grads:
            g = sp.row_sparse_array((data, rows), shape=(12, 3),
                                    ctx=mx.cpu())
            before = w.asnumpy()
            opt.update(0, w, g, state)
            st = None if state is None else state.asnumpy()
            trace.append((before, w.asnumpy(), st, rows))
        runs.append(trace)
    return runs


def _check_lazy(runs):
    for (before, tw, ts, rows), (_, jw, js, _) in zip(*runs):
        np.testing.assert_allclose(tw, jw, **EXACT)
        if ts is not None:
            np.testing.assert_allclose(ts, js, **EXACT)
        untouched = np.setdiff1d(np.arange(12), rows)
        np.testing.assert_array_equal(tw[untouched], before[untouched])
        assert not np.array_equal(tw[rows], before[rows])


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("clip,wd", [(None, 0.0), (0.05, 0.01)],
                         ids=["plain", "clip_wd"])
def test_lazy_sgd_matches_mxtpu(steps, momentum, clip, wd):
    _check_lazy(_lazy_run("sgd", steps, learning_rate=0.1,
                          momentum=momentum, wd=wd, clip_gradient=clip,
                          rescale_grad=0.5))


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("clip,wd", [(None, 0.0), (0.05, 0.01)],
                         ids=["plain", "clip_wd"])
def test_lazy_adagrad_matches_mxtpu(steps, clip, wd):
    _check_lazy(_lazy_run("adagrad", steps, learning_rate=0.1, wd=wd,
                          clip_gradient=clip, rescale_grad=0.5))


def test_optimizers_decline_fused_update_of_sparse_grads():
    """SGD and Adam take a tree with a sparse gradient one parameter at
    a time (the lazy SGD; Adam densified), as the JAX package does."""
    w0 = np.ones((4, 2), np.float32)
    for name in ("sgd", "adam"):
        res = []
        for mx, sp, arr in ((tmx, tsp, _tnd), (jmx, jsp, jmx.nd.array)):
            opt = mx.optimizer.create(name, learning_rate=0.1)
            ws = [arr(w0), arr(w0)]
            gs = [sp.row_sparse_array((np.ones((1, 2), np.float32), [2]),
                                      shape=(4, 2), ctx=mx.cpu()),
                  arr(np.full((4, 2), 0.5, np.float32))]
            upd = mx.optimizer.get_updater(opt)
            if mx is tmx:
                states = [upd._state(i, w) for i, w in enumerate(ws)]
                assert not opt.fused_update_multi([0, 1], ws, gs, states)
            upd.update_multi([(0, gs[0], ws[0]), (1, gs[1], ws[1])])
            res.append([w.asnumpy() for w in ws])
        for a, b in zip(*res):
            np.testing.assert_allclose(a, b, **EXACT)
