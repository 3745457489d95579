"""The PyTorch port's lr schedulers (`mxtpu_torch/lr_scheduler.py`) and
the optimizers' scheduled rates against the JAX package's
(`mxtpu/lr_scheduler.py`, `mxtpu/optimizer/optimizer.py`): the same
host arithmetic, so every rate must be equal, not close."""
import numpy as np
import pytest

import mxtpu as jmx
import mxtpu_torch as tmx
from mxtpu_torch.base import MXNetError
import torch

torch.set_num_threads(1)

_SCHEDULERS = [
    ("FactorScheduler", dict(step=7, factor=0.5)),
    ("FactorScheduler", dict(step=3, factor=0.9, stop_factor_lr=0.004,
                             base_lr=0.1)),
    ("FactorScheduler", dict(step=10, factor=0.5, warmup_steps=20,
                             warmup_begin_lr=0.001)),
    ("MultiFactorScheduler", dict(step=[10, 50, 120], factor=0.3)),
    ("MultiFactorScheduler", dict(step=[30, 60], factor=0.5, base_lr=0.2,
                                  warmup_steps=15, warmup_mode="constant",
                                  warmup_begin_lr=0.05)),
    ("PolyScheduler", dict(max_update=150, base_lr=0.1, pwr=2)),
    ("PolyScheduler", dict(max_update=180, base_lr=0.1, pwr=1,
                           final_lr=0.01, warmup_steps=25)),
    ("CosineScheduler", dict(max_update=160, base_lr=0.3, final_lr=0.02)),
    ("CosineScheduler", dict(max_update=200, base_lr=0.3, warmup_steps=40,
                             warmup_begin_lr=0.01)),
]


@pytest.mark.parametrize("name,kw", _SCHEDULERS)
def test_scheduler_rates_equal_the_reference(name, kw):
    t = getattr(tmx.lr_scheduler, name)(**kw)
    j = getattr(jmx.lr_scheduler, name)(**kw)
    got = [t(n) for n in range(201)]
    assert got == [j(n) for n in range(201)]
    assert len(set(got)) > 1


@pytest.mark.parametrize("make", [
    lambda m: m.LRScheduler(base_lr=0.01, warmup_begin_lr=0.1),
    lambda m: m.FactorScheduler(step=0),
    lambda m: m.FactorScheduler(step=2, factor=1.5),
    lambda m: m.MultiFactorScheduler(step=[5, 3]),
])
def test_bad_arguments_raise(make):
    with pytest.raises(MXNetError):
        make(tmx.lr_scheduler)
    with pytest.raises(jmx.MXNetError):
        make(jmx.lr_scheduler)


def test_bad_warmup_mode_raises():
    s = tmx.lr_scheduler.FactorScheduler(step=2, warmup_steps=5,
                                         warmup_mode="cubic")
    with pytest.raises(MXNetError, match="warmup_mode"):
        s(1)


_NAMES = ["conv_weight", "conv_bias", "bn_gamma", "fc_weight"]


def _advanced(mx, name, kw, steps):
    """An optimizer with a scheduler, an lr multiplier and ``steps``
    per-step updates behind it (counts advanced by its updater)."""
    opt = mx.optimizer.create(
        name, param_idx2name=dict(enumerate(_NAMES)),
        lr_scheduler=mx.lr_scheduler.MultiFactorScheduler(step=[2, 5],
                                                          factor=0.5),
        **kw)
    opt.set_lr_mult({"conv_bias": 2.0, "fc_weight": 0.5})
    upd = mx.optimizer.get_updater(opt)
    rng = np.random.RandomState(1)
    ctx = {"ctx": mx.cpu()} if mx is tmx else {}
    ws = [mx.nd.array(rng.randn(3).astype(np.float32), **ctx)
          for _ in _NAMES]
    for _ in range(steps):
        upd.update_multi([(i, mx.nd.array(rng.randn(3).astype(np.float32),
                                          **ctx), w)
                          for i, w in enumerate(ws)])
    return opt, ws


@pytest.mark.parametrize("name,kw", [
    ("sgd", dict(learning_rate=0.1, momentum=0.9)),
    ("adam", dict(learning_rate=0.01)),
])
@pytest.mark.parametrize("steps", [0, 3])
def test_host_sched_equals_the_reference(name, kw, steps):
    """The (k, n) effective rates of the next k steps, scheduler, lr
    multipliers and Adam's bias correction included, with no counter
    changed."""
    rows = {}
    for mx in (tmx, jmx):
        opt, ws = _advanced(mx, name, kw, steps)
        before = (opt.num_update, dict(opt._index_update_count))
        rows[mx] = opt.make_scan_step(range(len(_NAMES)), ws).host_sched(6)
        assert (opt.num_update, dict(opt._index_update_count)) == before
    assert rows[tmx].dtype == np.float32 and rows[tmx].shape == (6, 4)
    np.testing.assert_array_equal(rows[tmx], rows[jmx])


def test_scheduler_drives_per_step_updates_as_the_reference():
    """Per-step SGD under a scheduler: the weights after 8 updates."""
    got = {mx: _advanced(mx, "sgd", dict(learning_rate=0.1), 8)
           for mx in (tmx, jmx)}
    for a, b in zip(got[tmx][1], got[jmx][1]):
        np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), rtol=1e-6,
                                   atol=1e-7)
    assert got[tmx][0].lr_scheduler.base_lr == \
        got[jmx][0].lr_scheduler.base_lr
    with pytest.raises(MXNetError, match="lr_scheduler"):
        got[tmx][0].set_learning_rate(0.5)
