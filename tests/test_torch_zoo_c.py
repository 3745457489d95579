"""MobileNet 0.25's forward and backward in training mode against the
JAX package's, anchored on the reference's float64
(`test_torch_zoo.py`'s docstring says why): at 32², batch 16,
hybridized, from the same Xavier weights and head gradient.  For the
output, the input gradient, every parameter gradient and every
parameter's value after the pass (the moving statistics move in
training):

* the port's float64 within `F64_TOL` of the reference's float64;
* the port's float32 within `ZOO_TOL` plus twice the reference's own
  float32 error (its float32 against its float64) of the reference's
  float32, and within `ZOO_TOL` plus that error of the float64.

A moving mean whose input has zero mean in exact arithmetic (after a
1x1 convolution of a BatchNorm's output) is held against 1e-2 of the
largest value's norm (`VALUE_FLOOR`), as a gradient that is zero in
exact arithmetic is.  MobileNet v2 0.25 runs in `test_torch_zoo_d.py`,
to keep each file under 30 s.
"""
import numpy as np
import pytest

import mxtpu as jmx
import mxtpu_torch as tmx
from test_torch_gluon import _x
from test_torch_zoo import (F64_TOL, ZOO_TOL, Reference64, _zoo,
                            one_torch_thread, pass_distances,
                            two_pass_batch_norm, zoo_draws, zoo_pass)
import torch

torch.set_num_threads(1)

VALUE_FLOOR = 1e-2

X = _x(16, 3, 32, 32)


def training_pass_check(name, tmp):
    """``name``'s training pass in both packages and both types: the
    port's first (on one thread), then the reference's float32 while a
    child process, started first so that its imports overlap the port's
    runs, computes its float64."""
    def make(mx):
        return getattr(_zoo(mx), name)(classes=10)

    ref = Reference64(tmp)
    try:
        with one_torch_thread():
            arrays, head = zoo_draws(make, X)
            t32 = zoo_pass(tmx, make, arrays, X, head, True)
            t64 = zoo_pass(tmx, make, arrays, X, head, True, "float64")
        ref.submit({name: dict(kind="pass", name=name, arrays=arrays, x=X,
                               head=head, train=True)})
        with pytest.MonkeyPatch.context() as mp:
            two_pass_batch_norm(mp)
            j32 = zoo_pass(jmx, make, arrays, X, head, True)
        j64 = ref.results()[name]
    finally:
        ref.close()
    exact = pass_distances(t64, j64, VALUE_FLOOR)
    bad = {k: v for k, v in exact.items() if not v <= F64_TOL}
    assert not bad, ("float64", bad)
    own = pass_distances(j32, j64, VALUE_FLOOR)
    port = pass_distances(t32, j32, VALUE_FLOOR)
    bad = {k: (v, own[k]) for k, v in port.items()
           if not v <= ZOO_TOL + 2 * own[k]}
    assert not bad, ("float32 against the reference's", bad)
    accuracy = pass_distances(t32, j64, VALUE_FLOOR)
    bad = {k: (v, own[k]) for k, v in accuracy.items()
           if not v <= ZOO_TOL + own[k]}
    assert not bad, ("float32 against float64", bad)
    assert t32[0].shape == (16, 10) and np.isfinite(t32[0]).all()
    return exact, own, port, accuracy


def test_mobilenet_training_pass_matches_mxtpu(tmp_path):
    training_pass_check("mobilenet0_25", tmp_path)
