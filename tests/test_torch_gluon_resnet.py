"""ResNet-18 v1 trained three steps through the PyTorch port's gluon
(hybridized and not: `hybridize()` -> CachedOp, `record()`,
`SoftmaxCrossEntropyLoss`, `backward`, `Trainer.step`) against the JAX
package's gluon, from the same initial state.

The network runs at batch 4, 3x64x64 with SGD (lr 0.01, momentum 0.9,
wd 1e-4).  Every step's losses, parameters and moving statistics are
held directly to the reference's float32 run, as relative L2 errors
(the worst tensor of each kind).  The first step must agree to 1e-4 on
the losses, 1e-3 on every parameter and 1e-4 on every moving statistic
(the bounds of `test_torch_module.py`, whose network this is).  Later
steps carry float32 rounding through training, most of all in a few
BatchNorm betas; `STEP_TOL` gives each step about three times the
port's reading on the CPU (loss / worst parameter / worst moving stat:
1.6e-5 / 5.6e-3 / 3.4e-6 after step 2, 4.5e-3 / 7.4e-3 / 1.7e-3 after
step 3).  After step 2 a moving-stat write-back that goes stale after
the first step reads 0.60, and momentum lost between steps 0.48.

The reference computes its BatchNorm statistics in two passes, as there
(ROADMAP §C).  At batch 2 and 32x32 the last stage normalises two
values a channel and the two packages part after the first step, so the
steps run at 4x64x64.  The initial state is drawn with numpy, as
`test_torch_module.py` draws it; the reference runs its three steps
once, imperatively (its hybridized run computes the same function), and
the port's hybridized and imperative runs are each held to them.

Run as a script, the file prints those readings at a batch and side
(default 4 64), with each package's distance from the port's float64
run beside them:

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_gluon_resnet.py 2 32
"""
import sys

import numpy as np
import pytest

import mxtpu as jmx
import mxtpu.ops.nn as jnn
import mxtpu_torch as tmx
from test_torch_gluon import _rel
from test_torch_gluon_train import _from, _train, _xavier
import torch

torch.set_num_threads(1)

B, HW = 4, 64
# (loss, parameters, moving stats) bounds on the relative L2 from the
# reference, for steps 1, 2 and 3.
STEP_TOL = [(1e-4, 1e-3, 1e-4), (1e-4, 2e-2, 1e-4), (2e-2, 2e-2, 5e-3)]


def _resnet18(mx):
    return mx.gluon.model_zoo.vision.resnet18_v1(classes=10)


def _reference(batch=B, side=HW):
    """The reference's three steps of ResNet-18 v1 (imperative), with
    two-pass BatchNorm statistics: (x, y, initial parameters, losses,
    parameters)."""
    rng = np.random.RandomState(0)
    x = rng.rand(batch, 3, side, side).astype(np.float32)
    y = rng.randint(0, 10, (batch,)).astype(np.float32)
    init = _xavier(_resnet18, x, rng)
    with pytest.MonkeyPatch.context() as mp:
        two_pass = jnn._single_pass_stats
        mp.setattr(jnn, "_single_pass_stats",
                   lambda jnp, x, axes, keepdims=False, force=False:
                   two_pass(jnp, x, axes, keepdims, force=False))
        net = _from(jmx, _resnet18, init)
        losses, params, _ = _train(jmx, net, x, y, 3, hybridize=False)
    return x, y, init, losses, params


def _worst(loss, params, want_loss, want_params):
    """One step's relative L2 errors: the losses, the worst parameter
    and the worst moving statistic, each as (error, name)."""
    assert set(params) == set(want_params)
    errs = [(_rel(params[k], want_params[k]), k) for k in want_params]
    return ((_rel(loss, want_loss), "loss"),
            max(e for e in errs if "running" not in e[1]),
            max(e for e in errs if "running" in e[1]))


@pytest.fixture(scope="module")
def resnet18_reference():
    return _reference()


@pytest.mark.parametrize("hybridize", [True, False])
def test_resnet18_three_trainer_steps_match_the_reference(
        hybridize, resnet18_reference):
    x, y, init, jl, jp = resnet18_reference
    tnet = _from(tmx, _resnet18, init)
    tl, tp, trainer = _train(tmx, tnet, x, y, 3, hybridize=hybridize)
    for step, tols in enumerate(STEP_TOL):
        for (err, name), tol in zip(
                _worst(tl[step], tp[step], jl[step], jp[step]), tols):
            assert err <= tol, (step + 1, name, err)
    stats = [k for k in tp[-1] if k.endswith("running_var")]
    assert len(stats) == 20 and all(np.all(tp[-1][k] > 0) for k in stats)
    assert not any(np.allclose(tp[-1][k], 1.0) for k in stats)
    assert tl[-1].mean() < tl[0].mean()
    assert trainer.step_count == 3
    assert (tnet._cached_op is not None) == hybridize


if __name__ == "__main__":
    batch, side = (int(a) for a in (sys.argv[1:3] or (B, HW)))
    x, y, init, jl, jp = _reference(batch, side)
    tl, tp, _ = _train(tmx, _from(tmx, _resnet18, init), x, y, 3)
    el, ep, _ = _train(tmx, _from(tmx, _resnet18, init, "float64"), x, y,
                       3, dtype="float64")
    for step in range(3):
        for what, got, want in (
                ("port-reference", (tl, tp), (jl, jp)),
                ("reference-float64", (jl, jp), (el, ep)),
                ("port-float64", (tl, tp), (el, ep))):
            print("step", step + 1, what, _worst(got[0][step], got[1][step],
                                                 want[0][step],
                                                 want[1][step]))
