"""The PyTorch port's op corpus (`mxtpu_torch/ops/`) against the JAX
package's (`mxtpu/ops/`), op by op, modelled on
`tests/test_operator.py`'s sweep.

`CASES` (`test_torch_op_cases.py`) holds one entry for every canonical
op the port registers:
the same numpy inputs (seeded) go through `mxtpu.nd.<op>` and
`mxtpu_torch.nd.<op>` on the CPU.  Every output must agree within
`RTOL` of the reference's value plus `ATOL` of the output's largest
magnitude (float32 arithmetic done in other orders); integer and
ordering results (comparisons, sorts, arg-reductions, index ops) must
be equal.  For a differentiable op, the inputs' gradients of a
random-weighted sum of the outputs are held to the same bound.  The
cases include the places where torch's default differs from the
reference's: `clip` at its bounds (gradient 0.5), ties of `max`/`min`,
`sort`/`argsort`/`topk` and `_maximum`, rounding at .5 and `mod` with
mixed signs.  Random ops are held by shape, dtype, finiteness and
moments (the mean and the variance each within 4 standard errors of
the distribution's), and the multinomial, unique-zipfian and shuffle
samplers by their contracts (`random_contracts`).

The sweep is one parametrised test, split over this file and
`test_torch_ops_b.py` to `_h.py` (`SHARDS`) to keep each file under
30 s.  A registered op without a case fails, and so does a case
without an op.
"""
import numpy as np
import pytest

import mxtpu as jmx
import mxtpu_torch as tmx
from mxtpu_torch.ops import registry as treg
from test_torch_op_cases import (CASES, CONTRACTS, MOMENTS, _a, _f, draw,
                                 error_units, grad_inputs, moment_errors,
                                 random_contracts, run_call)
import torch

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
SHARDS = 8


def _canonical_ops():
    return sorted(n for n in treg.list_ops() if treg.get_op(n).name == n)


def close(got, want, what, exact=False, rtol=RTOL, atol=ATOL):
    err = error_units(got, want, exact, rtol, atol)
    assert err <= 1.0, (what, err, np.asarray(got).shape,
                        np.asarray(want).shape)


def check_call(name, c):
    grad_idx = grad_inputs(treg.get_op(name), c)
    jo, jg = run_call(jmx, name, c, jmx.cpu(), grad_idx)
    to, tg = run_call(tmx, name, c, tmx.cpu(), grad_idx)
    assert len(to) == len(jo), (name, len(to), len(jo))
    for k, (t, j) in enumerate(zip(to, jo)):
        close(t, j, "%s output %d" % (name, k), c.exact)
    for i, t, j in zip(grad_idx, tg, jg):
        close(t, j, "%s gradient of input %d" % (name, i))


def run_case(name):
    if name not in CASES:
        pytest.fail("op %r is registered in the port but has no case in "
                    "tests/test_torch_op_cases.py" % name)
    if name not in _canonical_ops():
        pytest.fail("case %r names no registered op" % name)
    assert CASES[name] or name in MOMENTS or name in CONTRACTS, name
    for c in CASES[name]:
        check_call(name, c)
    if name in SPECIAL:
        SPECIAL[name]()


def shard(k):
    return sorted(set(_canonical_ops()) | set(CASES))[k::SHARDS]


def _block_grad():
    """``BlockGrad(x) * x`` has the gradient ``x`` in both packages."""
    x = _a(3, 4, seed=3)
    grads = []
    for mx in (jmx, tmx):
        a = mx.nd.array(x, ctx=mx.cpu())
        a.attach_grad()
        with mx.autograd.record():
            y = mx.nd.BlockGrad(a) * a
        y.backward()
        grads.append(a.grad.asnumpy())
    close(grads[1], grads[0], "BlockGrad")
    close(grads[1], x, "BlockGrad against x")



def _moments(name):
    def check():
        _, mean, std, _ = MOMENTS[name]
        tmx.random.seed(3)
        x, dtype = draw(tmx, name, 20000, tmx.cpu())
        assert x.shape == (20000,) and x.dtype == dtype, (x.shape, x.dtype)
        assert np.isfinite(x).all()
        err_mean, err_var = moment_errors(x, mean, std)
        assert err_mean < 4 and err_var < 4, (name, err_mean, err_var)
    return check


def _contract(name):
    def check():
        bad = dict(random_contracts(tmx, tmx.cpu()))[name]
        assert bad is None, (name, bad)
    return check


def _dropout():
    """Training: each element kept with probability 1 - p and scaled by
    1 / (1 - p)."""
    x = np.ones((200, 100), np.float32)
    tmx.random.seed(5)
    a = tmx.nd.array(x, ctx=tmx.cpu())
    with tmx.autograd.train_mode():
        y = tmx.nd.Dropout(a, p=0.25).asnumpy()
    kept = y != 0
    assert set(np.unique(y)) <= {0.0, np.float32(1 / 0.75)}
    assert abs(kept.mean() - 0.75) < 4 * np.sqrt(0.75 * 0.25 / x.size)


# checks beside the calls: what needs more than one op or draws
SPECIAL = dict({n: _moments(n) for n in MOMENTS}, BlockGrad=_block_grad,
               Dropout=_dropout, **{n: _contract(n) for n in CONTRACTS})


@pytest.mark.parametrize("name", shard(0))
def test_op_sweep(name):
    run_case(name)


def test_every_registered_op_has_a_case_in_one_shard():
    names = sorted(set(_canonical_ops()) | set(CASES))
    assert sorted(n for k in range(SHARDS) for n in shard(k)) == names
    assert set(CASES) == set(_canonical_ops())


# ---------------------------------------------------------------------------
# the port's own values where torch's default differs
# ---------------------------------------------------------------------------

def _port_grad(op, x, **attrs):
    a = tmx.nd.array(x, ctx=tmx.cpu())
    a.attach_grad()
    with tmx.autograd.record():
        y = getattr(tmx.nd, op)(a, **attrs)
    y.backward()
    return y.asnumpy(), a.grad.asnumpy()


def test_abs_gradient_is_one_at_zero():
    y, g = _port_grad("abs", _f([-2, -0.0, 0, 3]))
    np.testing.assert_array_equal(g, [-1, 1, 1, 1])
    assert not np.signbit(y).any()


def test_clip_gradient_is_half_at_the_bounds():
    _, g = _port_grad("clip", _f([-1, -0.5, 0, 0.5, 1]), a_min=-0.5,
                      a_max=0.5)
    np.testing.assert_array_equal(g, [0, 0.5, 1, 0.5, 0])


def test_max_splits_the_gradient_over_ties():
    _, g = _port_grad("max", _f([[1, 3, 3], [0, 2, 1]]), axis=1)
    np.testing.assert_array_equal(g, [[0, 0.5, 0.5], [0, 1, 0]])


def test_round_is_half_to_even_and_mod_takes_the_divisor_sign():
    x = tmx.nd.array(_f([-2.5, -0.5, 0.5, 1.5, 2.5]), ctx=tmx.cpu())
    np.testing.assert_array_equal(tmx.nd.round(x).asnumpy(),
                                  [-2, -0, 0, 2, 2])
    m = tmx.nd.broadcast_mod(tmx.nd.array(_f([-3, 3]), ctx=tmx.cpu()),
                             tmx.nd.array(_f([2, -2]), ctx=tmx.cpu()))
    np.testing.assert_array_equal(m.asnumpy(), [1, -1])


def test_ties_order_in_sort_and_topk():
    x = tmx.nd.array(_f([1, 3, 3, 0, 3]), ctx=tmx.cpu())
    np.testing.assert_array_equal(
        tmx.nd.argsort(x, is_ascend=False).asnumpy(), [4, 2, 1, 0, 3])
    np.testing.assert_array_equal(tmx.nd.topk(x, k=3).asnumpy(), [1, 2, 4])
    np.testing.assert_array_equal(
        tmx.nd.topk(x, k=2, is_ascend=True).asnumpy(), [3, 0])
