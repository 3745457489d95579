"""The CIFAR-10 ResNet-18 input pipeline (`test_torch_cifar_net.py`) on
the PyTorch port against the JAX package, on the CPU: small CIFAR-10
files written by the test in the published binary format, read by
`gluon.data.vision.CIFAR10`, transformed (`ToTensor`, `Normalize`; the
random flip left out) and batched by a seeded `DataLoader`, into
`resnet18_v1(classes=10)` at batch 4 for 2 Trainer iterations (SGD lr
0.1, momentum 0.9, wd 5e-4) from the same numpy weights.

The port's batches are equal inline, with threads and through the
numpy pipeline (`numpy_dataset`, what process workers run), and within
a last float32 bit of the reference's (its Normalize may round the
division differently: 1e-6 of the largest magnitude).  The losses and
parameters are held as relative L2 errors (the worst tensor of each
kind, and the whole update of the parameters from their initial values)
to `STEP_TOL`: float32 rounding carried through training at lr 0.1,
with the reference computing its BatchNorm statistics in two passes as
there (ROADMAP §C); at 32x32 the last stage normalises 4 values a
channel.  The bounds are about three times the port's readings on the
CPU (iteration 1: 3.0e-6, 8.0e-5, 4.0e-6, 6.5e-5; iteration 2: 1.4e-4,
3.9e-2 (a BatchNorm beta of stage 3), 1.3e-4, 3.4e-3).
"""
import threading

import numpy as np
import pytest
import torch

import mxtpu as jmx
import mxtpu.ops.nn as jnn
import mxtpu_torch as tmx
from mxtpu_torch import context as tcontext
import test_torch_cifar_net as cifar
from test_torch_gluon import _rel
from test_torch_gluon_data import LOADER_THREADS
from test_torch_gluon_train import _from, _xavier

torch.set_num_threads(1)

BATCH, SEED, PER_FILE = 4, 5, 4
# (loss, worst parameter, worst moving stat, whole update) for
# iterations 1 and 2
STEP_TOL = [(1e-5, 3e-4, 1.5e-5, 2e-4), (5e-4, 0.12, 5e-4, 1e-2)]


@pytest.fixture
def root(tmp_path, monkeypatch):
    monkeypatch.setattr(tcontext, "default_ctx", lambda: torch.device("cpu"))
    cifar.write_cifar10(str(tmp_path), per_file=PER_FILE, seed=1)
    yield str(tmp_path)
    for t in threading.enumerate():  # every loader thread joined
        if t.name in LOADER_THREADS:
            t.join(timeout=10)
            assert not t.is_alive(), t.name


def _batches(mx, root, workers, n=3):
    out = []
    for x, y in cifar.loader(mx, root, BATCH, workers, SEED, flip=False):
        out.append((x.asnumpy(), y.asnumpy()))
        if len(out) == n:
            break
    return out


def test_the_pipeline_batches_match_the_reference(root):
    want = _batches(jmx, root, 0)
    assert want[0][0].shape == (BATCH, 3, 32, 32)
    assert want[0][0].dtype == np.float32 and want[0][1].dtype == np.int32
    numpy_batches = [tuple(b.asnumpy() for b in batch) for batch in
                     tmx.gluon.data.DataLoader(
                         cifar.numpy_dataset(tmx, root), batch_size=BATCH,
                         shuffle=True, last_batch="discard", seed=SEED)][:3]
    inline = _batches(tmx, root, 0)
    for (gx, gy), (wx, wy) in zip(inline, want):
        np.testing.assert_allclose(gx, wx, rtol=0,
                                   atol=1e-6 * np.abs(wx).max())
        np.testing.assert_array_equal(gy, wy)
    for got in (_batches(tmx, root, 2), numpy_batches):
        assert len(got) == len(inline) == 3
        for (gx, gy), (wx, wy) in zip(got, inline):
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)


def _train(mx, root, init, steps=2):
    net = _from(mx, cifar_net, init)
    net.hybridize()
    step = cifar.trainer(mx, net)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    losses, params = [], []
    for x, y in cifar.loader(mx, root, BATCH, 0, SEED, flip=False):
        losses.append(cifar.iteration(mx, net, step, loss_fn, x,
                                      y).asnumpy())
        params.append({k: p.data().asnumpy()
                       for k, p in net.collect_params().items()})
        if len(losses) == steps:
            break
    return losses, params


def cifar_net(mx):
    return mx.gluon.model_zoo.vision.resnet18_v1(classes=10)


def test_two_iterations_of_resnet18_match_the_reference(root):
    x = np.random.RandomState(0).rand(BATCH, 3, 32, 32).astype(np.float32)
    init = _xavier(cifar_net, x, np.random.RandomState(0))
    with pytest.MonkeyPatch.context() as mp:
        two_pass = jnn._single_pass_stats
        mp.setattr(jnn, "_single_pass_stats",
                   lambda jnp, x, axes, keepdims=False, force=False:
                   two_pass(jnp, x, axes, keepdims, force=False))
        jl, jp = _train(jmx, root, init)
    tl, tp = _train(tmx, root, init)
    for step, tols in enumerate(STEP_TOL):
        assert set(tp[step]) == set(jp[step])
        errs = [(_rel(tp[step][k], jp[step][k]), k) for k in jp[step]]
        keys = sorted(k for k in jp[step] if "running" not in k)
        moved = [np.concatenate([(p[step][k] - init[k]).ravel()
                                 for k in keys]) for p in (tp, jp)]
        got = (_rel(tl[step], jl[step]),
               max(e for e in errs if "running" not in e[1])[0],
               max(e for e in errs if "running" in e[1])[0],
               _rel(*moved))
        for err, tol, what in zip(got, tols, ("loss", "parameters",
                                              "moving stats", "update")):
            assert err <= tol, (step + 1, what, err)
        assert np.isfinite(tl[step]).all()
