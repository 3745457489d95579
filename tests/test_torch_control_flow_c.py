"""`_cond` on the path a CUDA-graph capture takes (no host read of the
predicate: both branches walked, the outputs selected with
`torch.where`), run on the CPU by patching `_no_host_read` as
`test_torch_control_flow_b.py` does: the branch not taken must give no
gradient even where its own derivative is infinite or NaN (a `sqrt` at
0 or below, a `log` at 0 or below), as the JAX package's `lax.cond`
differentiates only the branch taken and the port's eager path walks
only that branch.  The branches share their input `x`.

Outputs and gradients must equal the JAX package's exactly: the branch
taken is `x * 0` or `x * 2`, whose values and gradients are exact in
float32.
"""
import numpy as np
import pytest

import mxtpu as jmx
import mxtpu_torch as tmx
from test_torch_control_flow_b import _eager_and_masked
import torch

torch.set_num_threads(1)

X = np.array([0.0, -1.0, 4.0], np.float32)

# (taken, not taken, the predicate); the branch not taken is singular at
# some element of X
CASES = {
    "sqrt": (lambda s, x: x * 0, lambda s, x: s.sqrt(x), 1.0),
    "log": (lambda s, x: x * 2, lambda s, x: s.log(x), 1.0),
    "rsqrt_else_taken": (lambda s, x: s.rsqrt(x), lambda s, x: x * 2, 0.0),
}


def _run(mx, name):
    then, other, p = CASES[name]
    s = mx.sym
    x = s.var("x")
    ex = s.contrib.cond(s.var("p"), lambda: then(s, x),
                        lambda: other(s, x)).simple_bind(
        ctx=mx.cpu(), grad_req={"x": "write", "p": "null"}, p=(1,),
        x=(3,))
    out = ex.forward(is_train=True, p=np.full(1, p, np.float32), x=X)
    ex.backward()
    return out[0].asnumpy(), ex.grad_dict["x"].asnumpy()


@pytest.mark.parametrize("name", sorted(CASES))
def test_masked_cond_differentiates_only_the_branch_taken(monkeypatch,
                                                          name):
    want = _run(jmx, name)
    eager, masked = _eager_and_masked(monkeypatch, lambda: _run(tmx, name))
    for got in (eager, masked):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    assert np.isfinite(masked[1]).all()


def test_masked_cond_gradient_at_the_probe():
    """The probe of ROADMAP's C9: cond(p = 1, x * 0, sqrt(x)) at
    x = [0, -1, 4] has the gradient [0, 0, 0]."""
    mp = pytest.MonkeyPatch()
    try:
        _, masked = _eager_and_masked(mp, lambda: _run(tmx, "sqrt"))
    finally:
        mp.undo()
    np.testing.assert_array_equal(masked[1], [0.0, 0.0, 0.0])
