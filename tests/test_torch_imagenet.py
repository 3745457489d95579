"""BASELINE config #4's script on the PyTorch port, on the CPU:
`examples/image-classification/train_imagenet.py` loaded into the port
(`test_torch_example_port.py`: its `common` and `symbols` helpers
rewritten, the files untouched) with NAG (lr 0.1, momentum 0.9, wd
1e-4), top-5 accuracy and a `device` store, ResNet-18 v1 at 3x32x32,
batch 4, 3 batches of its synthetic data.

Both packages start from the same weights: the port's trace of the
network, initialised by its `MSRAPrelu` and saved as epoch 0, which
each run loads (`--load-epoch 0`; the JAX package reads the port's
checkpoint), so the same graph trains in both.  After each update the
parameters and moving statistics are read (`Module.update` wrapped)
and held to the JAX package's run of the unchanged script with its
BatchNorm statistics computed in two passes (as `test_torch_module.py`
runs it), as relative L2 errors of all parameters together and of all
moving statistics together.

At batch 4 and 32x32 the last stage normalises four values a channel,
and float32 rounding grows through the steps, so the bound after the
second and third updates is the JAX package's own spread: its run with
one-pass statistics against its two-pass run, times `SPREAD` (5).  Over
three weight draws the port's distance over that spread read 0.25 to
1.33, and once 4.18 (the moving statistics after the third update).
The first update is held directly (`FIRST_TOL`: all parameters, the
worst parameter, all moving statistics; readings at most 1.6e-4,
2.0e-4 and 1.9e-7).  A NAG step taken as plain SGD moves the first
update by 90%.

Then the script as the card runs it, the weights drawn by
`--initializer msra`: the Speedometer's lines print with
`top_k_accuracy_5`, the loss is finite and the epoch's checkpoint is
written.
"""
import logging
import os

import numpy as np
import pytest
import torch

import mxtpu as jmx
import mxtpu.ops.nn as jnn
import mxtpu_torch as tmx
from mxtpu_torch import context as tcontext
from test_torch_example_port import imagenet_helpers, run_train_imagenet

torch.set_num_threads(1)

# the first update's bounds on the relative L2 from the reference (all
# parameters, the worst parameter, all moving statistics); the later
# updates' in units of the reference's own spread
FIRST_TOL = (5e-4, 1e-3, 1e-6)
SPREAD = 5
ARGS = ["--benchmark", "1", "--network", "resnet", "--num-layers", "18",
        "--num-classes", "10", "--image-shape", "3,32,32", "--batch-size",
        "4", "--kv-store", "device", "--optimizer", "nag", "--mom", "0.9",
        "--wd", "1e-4", "--lr", "0.1", "--initializer", "msra", "--top-k",
        "5", "--num-epochs", "1", "--max-batches", "3", "--num-examples",
        "64", "--disp-batches", "1", "--num-devices", "1"]


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _initial_checkpoint(prefixes):
    """The port's ResNet-18 v1 trace, its weights drawn by MSRAPrelu,
    saved as epoch 0 under each prefix."""
    with imagenet_helpers(port=True) as mods:
        sym = mods["symbols.zoo"].get_symbol(
            network="resnet", num_layers=18, num_classes=10,
            image_shape=(3, 32, 32))
    mod = tmx.mod.Module(sym, context=tmx.cpu())
    mod.bind([("data", (4, 3, 32, 32))], [("softmax_label", (4,))])
    tmx.random.seed(0)
    mod.init_params(tmx.init.MSRAPrelu())
    for prefix in prefixes:
        mod.save_checkpoint(prefix, 0)


def _whole(a, b):
    """The relative L2 of all of ``a``'s arrays together from ``b``'s."""
    return float(np.sqrt(sum(((a[k] - b[k]) ** 2).sum() for k in b)) /
                 np.sqrt(sum((b[k] ** 2).sum() for k in b)))


def _trajectory(mx, port, prefix, monkeypatch):
    """The script's run from the checkpoint: (parameters, moving
    statistics) as numpy after each update, and the Module."""
    trail = []
    real_update = mx.mod.Module.update

    def update(self):
        real_update(self)
        arg, aux = self.get_params()
        trail.append(({k: v.asnumpy() for k, v in arg.items()},
                      {k: v.asnumpy() for k, v in aux.items()}))

    monkeypatch.setattr(mx.mod.Module, "update", update)
    mod = run_train_imagenet(ARGS + ["--model-prefix", prefix,
                                     "--load-epoch", "0"], port=port,
                             trace=port)
    monkeypatch.undo()
    return trail, mod


def test_train_imagenet_on_the_port_follows_the_reference(
        tmp_path, monkeypatch):
    monkeypatch.setattr(tcontext, "default_ctx", lambda: torch.device("cpu"))
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    os.makedirs(jdir)
    os.makedirs(tdir)
    _initial_checkpoint([str(jdir / "r18"), str(tdir / "r18")])
    got, mod = _trajectory(tmx, True, str(tdir / "r18"), monkeypatch)
    assert isinstance(mod, tmx.mod.Module)
    assert type(mod._optimizer).__name__ == "NAG"
    assert mod._update_on_kvstore
    with monkeypatch.context() as mp:
        two_pass = jnn._single_pass_stats
        mp.setattr(jnn, "_single_pass_stats",
                   lambda jnp, x, axes, keepdims=False, force=False:
                   two_pass(jnp, x, axes, keepdims, force=False))
        ref, _ = _trajectory(jmx, False, str(jdir / "r18"), mp)
    with monkeypatch.context() as mp:
        one_pass, _ = _trajectory(jmx, False, str(jdir / "r18"), mp)
    assert len(got) == len(ref) == len(one_pass) == 3
    for step, ((tp, ta), (jp, ja), (op, oa)) in enumerate(
            zip(got, ref, one_pass)):
        assert set(tp) == set(jp) and set(ta) == set(ja)
        if step == 0:
            readings = (_whole(tp, jp), max(_rel(tp[k], jp[k]) for k in jp),
                        _whole(ta, ja))
            assert all(r <= b for r, b in zip(readings, FIRST_TOL)), \
                readings
        else:
            assert _whole(tp, jp) <= SPREAD * _whole(op, jp), step
            assert _whole(ta, ja) <= SPREAD * _whole(oa, ja), step
    start = tmx.nd.load(str(tdir / "r18-0000.params"), ctx=tmx.cpu())
    for k, v in got[-1][0].items():
        assert not np.array_equal(v, start["arg:" + k].asnumpy()), k


def test_train_imagenet_on_the_port_with_msra(tmp_path, monkeypatch,
                                              caplog):
    monkeypatch.setattr(tcontext, "default_ctx", lambda: torch.device("cpu"))
    first = []
    real_update = tmx.mod.Module.update

    def update(self):
        if not first:
            first.extend(v.asnumpy() for v in self.get_params()[0].values()
                         if v.shape == (64, 3, 7, 7))
        real_update(self)

    monkeypatch.setattr(tmx.mod.Module, "update", update)
    tmx.random.seed(0)
    with caplog.at_level(logging.INFO):
        mod = run_train_imagenet(ARGS + ["--model-prefix",
                                         str(tmp_path / "r18")])
    lines = [r.getMessage() for r in caplog.records]
    assert sum("Speed:" in line and "top_k_accuracy_5=" in line
               for line in lines) == 2, lines
    assert (tmp_path / "r18-0001.params").exists()
    out = mod.get_outputs()[0].asnumpy()
    assert out.shape == (4, 10) and np.isfinite(out).all()
    # MSRAPrelu's first convolution: variance 2 / (1 + 0.25^2) over the
    # mean of the fans, 3 x 49 and 64 x 49
    want = np.sqrt(2 / 1.0625 / ((3 + 64) * 49 / 2.0))
    assert len(first) == 1 and abs(first[0].std() - want) < 0.05 * want


def test_the_loader_renames_every_import():
    """No module loaded into the port imports the JAX package."""
    with imagenet_helpers(port=True) as mods:
        for name, mod in mods.items():
            for value in vars(mod).values():
                owner = getattr(value, "__module__", None) or getattr(
                    value, "__name__", "")
                assert not str(owner).startswith("mxtpu.")
                assert str(owner) != "mxtpu", (name, value)
    with pytest.raises(AssertionError):
        # a count that no longer matches the file fails the loader
        from test_torch_example_port import IMAGENET_FILES, port_source

        saved = IMAGENET_FILES["common/fit.py"]
        IMAGENET_FILES["common/fit.py"] = (5, 2, 1)
        try:
            port_source("common/fit.py")
        finally:
            IMAGENET_FILES["common/fit.py"] = saved
