"""Sparse training in the PyTorch port against the JAX package, on the CPU.

* ``LibSVMIter``: CSR batches and labels, ``round_batch``'s wrap and
  ``pad``, shards (``num_parts``/``part_index``), a label file, an
  empty shard.
* ``examples/sparse/linear_classification.py`` itself, its imports of
  ``mxtpu`` turned into ``mxtpu_torch`` (``load_example``): three steps
  of its loop (``forward``, ``loss_fn``) with AdaGrad and with SGD
  through an Updater, and with AdaGrad on ``kv.create("local")``
  (``row_sparse_pull`` of the batch's columns, rows-only pushes),
  against the JAX package running the unchanged example from the same
  weights: the loss, the weight and the optimizer state at each step.
  Then its ``main()`` on the port at ``tests/test_examples.py``'s size
  (50,000 features, 1,500 rows, 2 epochs, AdaGrad), with and without
  the local store: at least 0.9 training accuracy.
* Three steps of ``examples/sparse/factorization_machine.py``'s model
  (CSR batches through ``sparse.dot`` into dense leaves, the example's
  own update) and of a gluon model with ``Embedding(sparse_grad=True)``
  under ``Trainer`` (SGD with momentum, AdaGrad), weights copied out of
  the JAX package.

The port's entry points run on the card unless told otherwise; the
example names no device, so these tests make the CPU the default
(``cpu_default``).  Tolerances (float32 sums in other orders):
``LOSS`` rtol 1e-5; ``WEIGHT`` atol 1e-5; ``STATE`` rtol 1e-4 and atol
1e-7 (AdaGrad's history is a sum of squared gradients).
"""
import os
import re
import sys
import types

import numpy as np
import pytest
import torch

import mxtpu as jmx
import mxtpu_torch as tmx
from mxtpu.io.io import LibSVMIter as JLibSVMIter
from mxtpu_torch import context as tcontext
from mxtpu_torch.io import LibSVMIter as TLibSVMIter
from mxtpu_torch.ndarray import sparse as tsp

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "examples", "sparse", "linear_classification.py")
FM_EXAMPLE = os.path.join(REPO, "examples", "sparse",
                          "factorization_machine.py")
CPU = tmx.cpu()
LOSS = dict(rtol=1e-5, atol=0)
WEIGHT = dict(rtol=0, atol=1e-5)
STATE = dict(rtol=1e-4, atol=1e-7)


def load_example(path, port):
    """The example as a module, on the JAX package or (``port``) on
    mxtpu_torch: every ``import mxtpu``/``from mxtpu`` line made to name
    the port instead."""
    with open(path) as f:
        src = f.read()
    name = os.path.splitext(os.path.basename(path))[0]
    if port:
        src, n = re.subn(r"^(import|from) mxtpu\b", r"\1 mxtpu_torch", src,
                         flags=re.M)
        assert n >= 1
        assert not re.search(r"^(import|from) mxtpu\b(?!_)", src, re.M)
    mod = types.ModuleType(name + ("_torch" if port else "_jax"))
    mod.__file__ = path
    exec(compile(src, path, "exec"), mod.__dict__)
    return mod


@pytest.fixture
def cpu_default(monkeypatch):
    monkeypatch.setattr(tcontext, "default_ctx", lambda: torch.device("cpu"))


# ---------------------------------------------------------------------------
# LibSVMIter
# ---------------------------------------------------------------------------

ROWS = "1 0:1.5 99:2.0\n0 5:1.0\n\n1 7:3.0 8:4.0\n0 0:2.5\n1 3:1.0\n"


def _batches(it):
    out = []
    for b in it:
        out.append((b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad))
    return out


@pytest.mark.parametrize("kw", [
    dict(batch_size=2), dict(batch_size=2, round_batch=False),
    dict(batch_size=3, num_parts=2, part_index=1),
    dict(batch_size=1, num_parts=2, part_index=0)],
    ids=["wrap_pad", "drop_last", "shard1", "shard0"])
def test_libsvm_iter_matches_mxtpu(kw, tmp_path):
    path = str(tmp_path / "d.libsvm")
    with open(path, "w") as f:
        f.write(ROWS)
    t = TLibSVMIter(data_libsvm=path, data_shape=(100,), ctx=CPU, **kw)
    j = JLibSVMIter(data_libsvm=path, data_shape=(100,), **kw)
    tb, jb = _batches(t), _batches(j)
    assert len(tb) == len(jb) > 0
    for (td, tl, tp), (jd, jl, jp) in zip(tb, jb):
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(tl, jl)
        assert tp == jp
    t.reset()
    first = t.next()
    assert isinstance(first.data[0], tsp.CSRNDArray)
    assert first.data[0].ctx == CPU and first.label[0].ctx == CPU
    assert first.data[0].indices._data.dtype == torch.int64
    if kw == dict(batch_size=2):
        assert [p for _, _, p in tb] == [0, 0, 1]


def test_libsvm_iter_label_file_and_empty_shard(tmp_path):
    d, lab = str(tmp_path / "d.libsvm"), str(tmp_path / "l.txt")
    with open(d, "w") as f:
        f.write("0 1:1\n0 2:1\n0 3:1\n")
    with open(lab, "w") as f:
        f.write("10 11\n20 21\n30 31\n")
    t = TLibSVMIter(data_libsvm=d, label_libsvm=lab, data_shape=(10,),
                    batch_size=1, num_parts=2, part_index=1, ctx=CPU)
    j = JLibSVMIter(data_libsvm=d, label_libsvm=lab, data_shape=(10,),
                    batch_size=1, num_parts=2, part_index=1)
    for (td, tl, _), (jd, jl, _) in zip(_batches(t), _batches(j)):
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(tl, jl)
    assert t.provide_label[0].shape == (1, 2)
    empty = TLibSVMIter(data_libsvm=d, data_shape=(10,), batch_size=1,
                        num_parts=4, part_index=3, ctx=CPU)
    with pytest.raises(StopIteration):
        empty.next()
    with pytest.raises(tmx.MXNetError, match="out of range"):
        next(iter(TLibSVMIter(data_libsvm=d, data_shape=(3,), batch_size=3,
                              ctx=CPU)))


# ---------------------------------------------------------------------------
# The linear classifier
# ---------------------------------------------------------------------------

F, B, N_ROWS = 2000, 64, 300


def _linear_run(port, data_path, optimizer, kv_local, lr):
    """Three steps of the example's loop; returns (loss, weight, state)
    after each."""
    ex = load_example(EXAMPLE, port)
    mx = tmx if port else jmx
    it_cls = TLibSVMIter if port else JLibSVMIter
    it = it_cls(data_libsvm=data_path, data_shape=(F,), batch_size=B)
    rng = np.random.RandomState(1)
    weight = mx.nd.array(rng.normal(0, 0.01, (F, 2)).astype(np.float32))
    bias = mx.nd.array(np.zeros((2,), np.float32))
    weight.attach_grad(stype="row_sparse")
    bias.attach_grad()
    opt = mx.optimizer.create(optimizer, learning_rate=lr,
                              rescale_grad=1.0 / B)
    updater = mx.optimizer.get_updater(opt)
    kv = None
    if kv_local:
        kv = mx.kv.create("local")
        kv.init("weight", weight)
        kv.init("bias", bias)
        kv.set_optimizer(opt)
    trace = []
    for _ in range(3):
        batch = it.next()
        if kv:
            kv.row_sparse_pull("weight", out=weight,
                               row_ids=batch.data[0].indices)
            kv.pull("bias", out=bias)
        with mx.autograd.record():
            logits = ex.forward(batch, weight, bias)
            loss = ex.loss_fn(logits, batch.label[0], 2.0)
        loss.backward()
        assert weight.grad.stype == "row_sparse"
        if kv:
            kv.push("weight", weight.grad)
            kv.push("bias", bias.grad)
            full = mx.nd.zeros((F, 2))
            kv.pull("weight", out=full)
            states = kv._updater.states
        else:
            updater(0, weight.grad, weight)
            updater(1, bias.grad, bias)
            full, states = weight, updater.states
        state = states.get("weight", states.get(0))
        trace.append((float(loss.asnumpy()), full.asnumpy(),
                      None if state is None else state.asnumpy(),
                      weight.grad.indices.asnumpy()))
    return trace


@pytest.mark.parametrize("optimizer,kv_local,lr", [
    ("adagrad", False, 0.1), ("sgd", False, 0.1 * B), ("adagrad", True, 0.1)],
    ids=["adagrad", "sgd", "kvlocal"])
def test_linear_classifier_steps_match_mxtpu(optimizer, kv_local, lr,
                                             tmp_path, cpu_default):
    path = str(tmp_path / "avazu_synth.libsvm")
    load_example(EXAMPLE, False).synthesize(path, num_rows=N_ROWS,
                                            num_features=F)
    t = _linear_run(True, path, optimizer, kv_local, lr)
    j = _linear_run(False, path, optimizer, kv_local, lr)
    for (tl, tw, ts, tids), (jl, jw, js, jids) in zip(t, j):
        np.testing.assert_allclose(tl, jl, **LOSS)
        np.testing.assert_allclose(tw, jw, **WEIGHT)
        if ts is not None:
            np.testing.assert_allclose(ts, js, **STATE)
        assert tids.tolist() == sorted(int(i) for i in jids if i < F)
    assert t[-1][0] < t[0][0]


@pytest.mark.parametrize("kvstore", [None, "local"])
def test_example_main_trains_on_the_port(kvstore, tmp_path, monkeypatch,
                                         cpu_default, capsys):
    ex = load_example(EXAMPLE, True)
    monkeypatch.setenv("MXTPU_DATA_DIR", str(tmp_path))
    argv = ["linear_classification.py", "--synthesize", "--num-epoch", "2",
            "--num-rows", "1500", "--num-features", "50000",
            "--min-accuracy", "0.9"]
    if kvstore:
        argv += ["--kvstore", kvstore]
    monkeypatch.setattr(sys, "argv", argv)
    ex.main()  # exits non-zero below --min-accuracy
    m = re.search(r"FINAL_ACCURACY ([0-9.]+)", capsys.readouterr().out)
    assert m and float(m.group(1)) >= 0.9


# ---------------------------------------------------------------------------
# The factorization machine
# ---------------------------------------------------------------------------

def _fm_run(mx, sp, w0, v0, xs, ys, lr):
    """The example's model and update (``factorization_machine.py``
    ``main``): three CSR batches."""
    arr = (lambda a: mx.nd.array(a, ctx=mx.cpu()))
    w, V, b = arr(w0), arr(v0), arr(np.zeros((1,), np.float32))
    for p in (w, V, b):
        p.attach_grad()

    def fm(xb):
        lin = sp.dot(xb, w).reshape((-1,)) + b
        xv = sp.dot(xb, V)
        return lin + 0.5 * ((xv ** 2).sum(axis=1)
                            - sp.dot(xb, V ** 2).sum(axis=1))

    def logloss(z, t):
        return (mx.nd.relu(z) - z * t
                + mx.nd.log(1 + mx.nd.exp(-mx.nd.abs(z)))).mean()

    trace = []
    for xb_np, yb in zip(xs, ys):
        xb = sp.csr_matrix(xb_np, ctx=mx.cpu()) if mx is tmx \
            else sp.csr_matrix(xb_np)
        with mx.autograd.record():
            loss = logloss(fm(xb), arr(yb))
        loss.backward()
        for p in (w, V, b):
            p -= lr * p.grad
            p.grad[:] = 0
        trace.append([float(loss.asnumpy())] + [p.asnumpy()
                                                for p in (w, V, b)])
    return trace


def test_factorization_machine_steps_match_mxtpu():
    ex = load_example(FM_EXAMPLE, False)
    rng = np.random.RandomState(7)
    x, y = ex.make_data(rng, 600)
    w0 = np.zeros((ex.D, 1), np.float32)
    v0 = rng.normal(0, 0.05, (ex.D, ex.K)).astype(np.float32)
    xs = [x[i:i + 200] for i in range(0, 600, 200)]
    ys = [y[i:i + 200] for i in range(0, 600, 200)]
    t = _fm_run(tmx, tsp, w0, v0, xs, ys, 0.3)
    j = _fm_run(jmx, jmx.nd.sparse, w0, v0, xs, ys, 0.3)
    for ts, js in zip(t, j):
        np.testing.assert_allclose(ts[0], js[0], **LOSS)
        for a, b in zip(ts[1:], js[1:]):
            np.testing.assert_allclose(a, b, **WEIGHT)
    assert t[-1][0] < t[0][0]


# ---------------------------------------------------------------------------
# gluon: Embedding(sparse_grad=True) under Trainer
# ---------------------------------------------------------------------------

def _gluon_net(mx):
    class Net(mx.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.emb = mx.gluon.nn.Embedding(500, 8, sparse_grad=True)
                self.out = mx.gluon.nn.Dense(1, in_units=8)

        def hybrid_forward(self, F, x):
            return self.out(F.sum(self.emb(x), axis=1))

    with mx.sym.NameManager():
        net = Net()
    net.initialize(ctx=mx.cpu())
    return net


@pytest.mark.parametrize("optimizer,params", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01}),
    ("adagrad", {"learning_rate": 0.1})], ids=["sgd_momentum", "adagrad"])
def test_gluon_sparse_embedding_trainer_steps_match_mxtpu(optimizer, params):
    rng = np.random.RandomState(3)
    jnet = _gluon_net(jmx)
    names = list(jnet.collect_params().keys())
    init = {n: rng.normal(0, 0.1, jnet.collect_params()[n].shape)
            .astype(np.float32) for n in names}
    batches = [(rng.randint(0, 500, (16, 5)).astype(np.float32),
                rng.randn(16, 1).astype(np.float32)) for _ in range(3)]
    traces = []
    for mx in (tmx, jmx):
        net = _gluon_net(mx)
        assert list(net.collect_params().keys()) == names
        for n, p in net.collect_params().items():
            p.set_data(mx.nd.array(init[n], ctx=mx.cpu()))
        trainer = mx.gluon.Trainer(net.collect_params(), optimizer,
                                   dict(params))
        loss_fn = mx.gluon.loss.L2Loss()
        trace = []
        for x, y in batches:
            with mx.autograd.record():
                loss = loss_fn(net(mx.nd.array(x, ctx=mx.cpu())),
                               mx.nd.array(y, ctx=mx.cpu()))
            loss.backward()
            assert net.emb.weight.grad().stype == "row_sparse"
            trainer.step(16)
            upd = trainer._updater if mx is tmx else trainer._updaters[0]
            state = upd.states[0]
            trace.append([float(loss.mean().asnumpy()),
                          state.asnumpy() if state is not None else None]
                         + [p.data().asnumpy()
                            for p in net.collect_params().values()])
        traces.append(trace)
    for ts, js in zip(*traces):
        np.testing.assert_allclose(ts[0], js[0], **LOSS)
        np.testing.assert_allclose(ts[1], js[1], **STATE)
        for a, b in zip(ts[2:], js[2:]):
            np.testing.assert_allclose(a, b, **WEIGHT)
