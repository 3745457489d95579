"""BASELINE config #1 on the PyTorch port, on the CPU:
`examples/image-classification/train_mnist.py --network lenet` through
`Module.fit`, and `io.MNISTIter`, against the JAX package.

* `MNISTIter` on small idx files that the test writes (the repo holds
  no MNIST files), plain and gzipped, `flat` or (1, 28, 28) images,
  shuffled with a seed or in order: the same batches as `mxtpu`'s.
* The example, loaded with its imports renamed to the port and
  `mx.tpu()`/`num_tpus()` renamed to `mx.gpu()`/`num_gpus()`
  (`load_example`): its `lenet_symbol` trained for one `fit` epoch on
  its synthetic data (`--dummy`, cut to 320 examples) from the same
  numpy weights as `mxtpu`'s run of the unchanged example, SGD with
  momentum 0.9; after every batch the parameters agree within
  `test_torch_module.py`'s relative L2 of 1e-3.  Then its `main()` on
  the port, which picks the CPU where `num_gpus()` is 0.
"""
import gzip
import os
import re
import struct
import sys
import types

import numpy as np
import pytest
import torch

import mxtpu as jmx
import mxtpu_torch as tmx
from mxtpu.io.io import MNISTIter as JMNISTIter
from mxtpu_torch import context as tcontext
from mxtpu_torch.io import MNISTIter as TMNISTIter

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "examples", "image-classification",
                       "train_mnist.py")
PARAM_TOL = 1e-3


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def load_example(port):
    """train_mnist.py as a module of the JAX package or (``port``) of
    mxtpu_torch, its imports (indented ones too) renamed, and the TPU
    device calls made the CUDA ones."""
    with open(EXAMPLE) as f:
        src = f.read()
    if port:
        src, n = re.subn(r"^(\s*)(import|from) mxtpu\b", r"\1\2 mxtpu_torch",
                         src, flags=re.M)
        assert n == 4, n
        src, m = re.subn(r"\bmx\.(tpu|num_tpus)\(",
                         lambda g: "mx.%s(" % {"tpu": "gpu",
                                               "num_tpus": "num_gpus"}[
                                                   g.group(1)], src)
        assert m == 2, m
    mod = types.ModuleType("train_mnist_" + ("torch" if port else "jax"))
    mod.__file__ = EXAMPLE
    exec(compile(src, EXAMPLE, "exec"), mod.__dict__)
    return mod


def _write_idx(path, arr, gz):
    code = {np.uint8: 0x08, np.int32: 0x0C, np.float32: 0x0D}[arr.dtype.type]
    head = struct.pack(">I", (code << 8) | arr.ndim) + \
        struct.pack(">" + "I" * arr.ndim, *arr.shape)
    body = head + arr.astype(arr.dtype.newbyteorder(">")).tobytes()
    with (gzip.open if gz else open)(path, "wb") as f:
        f.write(body)


@pytest.mark.parametrize("gz", [False, True], ids=["idx", "gz"])
@pytest.mark.parametrize("kw", [
    dict(batch_size=4, shuffle=True, seed=3),
    dict(batch_size=5, shuffle=False, flat=True),
    dict(batch_size=4, shuffle=True, flat=True)],
    ids=["shuffled", "flat_in_order", "flat_shuffled"])
def test_mnist_iter_matches_mxtpu(kw, gz, tmp_path):
    rng = np.random.RandomState(0)
    ext = ".gz" if gz else ""
    img = str(tmp_path / ("images-idx3-ubyte" + ext))
    lab = str(tmp_path / ("labels-idx1-ubyte" + ext))
    _write_idx(img, rng.randint(0, 256, (18, 28, 28)).astype(np.uint8), gz)
    _write_idx(lab, rng.randint(0, 10, 18).astype(np.uint8), gz)
    ji = JMNISTIter(image=img, label=lab, **kw)
    ti = TMNISTIter(image=img, label=lab, ctx=tmx.cpu(), **kw)
    assert [tuple(d.shape) for d in ti.provide_data] == \
        [tuple(d.shape) for d in ji.provide_data]
    for _ in range(2):
        ji.reset()
        ti.reset()
        jb, tb = list(ji), list(ti)
        assert len(tb) == len(jb) == 18 // kw["batch_size"]
        for j, t in zip(jb, tb):
            np.testing.assert_array_equal(t.data[0].asnumpy(),
                                          j.data[0].asnumpy())
            np.testing.assert_array_equal(t.label[0].asnumpy(),
                                          j.label[0].asnumpy())


def _fit_one_epoch(port, args):
    ex = load_example(port)
    mx = tmx if port else jmx
    opts = types.SimpleNamespace(data_dir="", dummy=True, num_examples=320,
                                 batch_size=64)
    np.random.seed(0)
    train, val = ex.get_iters(opts, (1, 28, 28))
    mod = mx.mod.Module(ex.lenet_symbol(), context=mx.cpu())
    trail = []

    def snapshot(param):
        trail.append({k: v.asnumpy()
                      for k, v in mod.get_params()[0].items()})

    mod.fit(train, eval_data=val, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            kvstore="local", num_epoch=1,
            arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                        for k, v in args.items()},
            aux_params={}, batch_end_callback=snapshot)
    return trail, mod.score(val, "acc")[0][1]


def test_lenet_fit_epoch_matches_mxtpu(monkeypatch):
    monkeypatch.setattr(tcontext, "default_ctx", lambda: torch.device("cpu"))
    sym = load_example(True).lenet_symbol()
    arg_shapes, _, _ = sym.infer_shape(data=(64, 1, 28, 28),
                                       softmax_label=(64,))
    rng = np.random.RandomState(5)
    args = {}
    for n, s in zip(sym.list_arguments(), arg_shapes):
        if n in ("data", "softmax_label"):
            continue
        fan = float(np.prod(s[1:])) if len(s) > 1 else 1.0
        args[n] = (rng.uniform(-1, 1, s) / np.sqrt(fan)).astype(np.float32) \
            if n.endswith("weight") else np.zeros(s, np.float32)
    (tt, tacc), (jt, jacc) = _fit_one_epoch(True, args), \
        _fit_one_epoch(False, args)
    assert len(tt) == len(jt) == 5  # 288 examples, the last batch padded
    for step, (ts, js) in enumerate(zip(tt, jt)):
        for k in ts:
            assert _rel(ts[k], js[k]) <= PARAM_TOL, (step, k)
    for k in args:
        assert not np.array_equal(tt[-1][k], args[k]), k
    assert abs(tacc - jacc) <= 1.0 / 32


def test_the_example_runs_on_the_port(monkeypatch):
    monkeypatch.setattr(tcontext, "default_ctx", lambda: torch.device("cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tmx.num_gpus() == 0
    ex = load_example(True)
    monkeypatch.setattr(sys, "argv", [EXAMPLE, "--network", "lenet",
                                      "--dummy", "--num-examples", "256",
                                      "--num-epochs", "1"])
    assert ex.main() == 0
