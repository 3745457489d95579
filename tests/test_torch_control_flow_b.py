"""The PyTorch port's control flow, continued (`test_torch_control_flow.py`
has the reference's seven cases): the subgraph's aux values written back
through a CachedOp (gluon, hybridized) against the JAX package's; the
paths a CUDA-graph capture takes (both branches of `_cond` selected with
`torch.where`, `max_iterations` masked steps of `_while_loop`), run on
the CPU and held equal to the eager paths; `FusedTrainLoop` over a
foreach RNN (K = 4) against the reference's per-step Module; a dropout
inside a foreach body, by its rate and a fresh mask each step.

Tolerances: float32's, rtol 1e-5 and atol 1e-5 times the largest
magnitude of the reference value; the fused RNN's weights after 4 SGD
steps at lr 0.5 within 1e-4.
"""
import numpy as np
import pytest

import mxtpu as jmx
import mxtpu_torch as tmx
from mxtpu_torch.gluon.parameter import load_numpy
from mxtpu_torch.ops import control_flow as tcf
from test_torch_control_flow import (_close, _nd, rnn_batches, rnn_module,
                                     rnn_weights)
import torch

torch.set_num_threads(1)


class _ForeachBN(object):
    """A HybridBlock whose foreach body runs a Dense and a BatchNorm: the
    moving statistics are aux values of the subgraph."""

    @staticmethod
    def make(mx):
        class Net(mx.gluon.HybridBlock):
            def __init__(self, **kw):
                super().__init__(**kw)
                with self.name_scope():
                    self.fc = mx.gluon.nn.Dense(3, in_units=4, flatten=False)
                    self.bn = mx.gluon.nn.BatchNorm(in_channels=3,
                                                    momentum=0.8)

            def hybrid_forward(self, F, x, h0):
                def step(xt, h):
                    hn = F.tanh(self.bn(self.fc(xt)) + h)
                    return hn, hn
                outs, _ = F.contrib.foreach(step, x, h0)
                return outs

        with mx.sym.NameManager():
            net = Net(prefix="fbn_")
        net.initialize(ctx=mx.cpu())
        return net


def _foreach_bn_run(mx, hybridize):
    net = _ForeachBN.make(mx)
    rng = np.random.RandomState(0)
    arrays = {k: (rng.uniform(0.5, 1.5, p.shape) if k.endswith("_var")
                  else rng.normal(0, 0.5, p.shape)).astype(np.float32)
              for k, p in sorted(net.collect_params().items())}
    if mx is tmx:
        load_numpy(net.collect_params(), arrays)
    else:
        for k, p in net.collect_params().items():
            p.set_data(jmx.nd.array(arrays[k], ctx=jmx.cpu()))
    if hybridize:
        net.hybridize()
    x = _nd(mx, rng.randn(5, 2, 4).astype(np.float32) * 2 + 1)
    h0 = _nd(mx, np.zeros((2, 3), np.float32))
    head = _nd(mx, rng.randn(5, 2, 3).astype(np.float32))
    with mx.autograd.record():
        out = net(x, h0)
    out.backward(head)
    params = net.collect_params()
    return (out.asnumpy(),
            {k: p.data().asnumpy() for k, p in params.items()},
            {k: p.grad().asnumpy() for k, p in params.items()
             if p.grad_req != "null"}, arrays)


@pytest.mark.parametrize("hybridize", [False, True])
def test_foreach_batchnorm_in_a_block_updates_the_moving_stats(hybridize):
    """Hybridized, the moving statistics come back from the subgraph
    through the CachedOp's write-back; imperatively, the BatchNorm block
    updates them at each step.  Both equal the reference's hybridized
    run, with the output and the gradients."""
    t = _foreach_bn_run(tmx, hybridize)
    j = _foreach_bn_run(jmx, True)
    _close(t[0], j[0], "output")
    assert set(t[1]) == set(j[1]) and set(t[2]) == set(j[2])
    for k in j[1]:
        _close(t[1][k], j[1][k], k)
    moved = [k for k in j[1] if k.endswith(("running_mean", "running_var"))]
    assert len(moved) == 2
    for k in moved:
        assert not np.allclose(t[1][k], t[3][k]), k
    for k in j[2]:
        _close(t[2][k], j[2][k], "gradient of %s" % k)


def _eager_and_masked(monkeypatch, fn):
    """fn() on the eager path, then on the path a CUDA-graph capture
    takes (no host read of a predicate)."""
    eager = fn()
    monkeypatch.setattr(tcf, "_no_host_read", lambda t: True)
    masked = fn()
    monkeypatch.undo()
    return eager, masked


@pytest.mark.parametrize("p", [1.0, 0.0])
def test_cond_selecting_both_branches_equals_the_branch_taken(monkeypatch,
                                                              p):
    def run():
        s = tmx.sym
        ex = tmx.sym.contrib.cond(
            s.var("p"), lambda: s.var("a") * s.var("a"),
            lambda: s.var("b") + 1).simple_bind(
                ctx=tmx.cpu(), grad_req={"a": "write", "b": "write",
                                         "p": "null"}, p=(1,), a=(3,),
                b=(3,))
        out = ex.forward(is_train=True, p=np.full(1, p, np.float32),
                         a=np.array([1, 2, 3], np.float32),
                         b=np.zeros(3, np.float32))[0].asnumpy()
        ex.backward()
        return out, ex.grad_dict["a"].asnumpy(), ex.grad_dict["b"].asnumpy()

    eager, masked = _eager_and_masked(monkeypatch, run)
    for e, m in zip(eager, masked):
        np.testing.assert_array_equal(e, m)
    np.testing.assert_array_equal(eager[1], [2, 4, 6] if p else [0, 0, 0])
    np.testing.assert_array_equal(eager[2], [0, 0, 0] if p else [1, 1, 1])


def test_while_loop_masked_steps_equal_the_eager_loop(monkeypatch):
    """At max_iterations 64 with a trip count that depends on the data
    (i doubles until it passes a bound): outputs, final loop variables."""
    def run():
        s = tmx.sym
        outs, fin = tmx.sym.contrib.while_loop(
            lambda i, a: s.sum(i) < s.sum(s.var("bound")),
            lambda i, a: ([i * a, a + 1], [i * 2, a + 1]),
            [s.var("i"), s.var("a")], max_iterations=64)
        ex = s.Group(outs + fin).simple_bind(ctx=tmx.cpu(), i=(1,), a=(2,),
                                             bound=(1,))
        return [o.asnumpy() for o in ex.forward(
            i=np.ones(1, np.float32), a=np.array([1, 2], np.float32),
            bound=np.array([1000], np.float32))]

    eager, masked = _eager_and_masked(monkeypatch, run)
    for e, m in zip(eager, masked):
        np.testing.assert_array_equal(e, m)
    assert eager[0].shape == (64, 2)
    assert (eager[0][10:] == 0).all() and (eager[0][9] != 0).all()
    np.testing.assert_array_equal(eager[2], [1024])


def test_fused_train_loop_over_a_foreach_rnn_matches_per_step_modules():
    """The port's FusedTrainLoop (K = 4, eager on the CPU) over the
    foreach RNN against 4 per-step Module steps of the reference."""
    batches = {mx: rnn_batches(mx, batch=12) for mx in (tmx, jmx)}
    fused = rnn_module(tmx, batch=12)
    tmx.FusedTrainLoop(fused, steps_per_program=4).run(batches[tmx])
    ref = rnn_module(jmx, batch=12)
    for b in batches[jmx]:
        ref.forward(b, is_train=True)
        ref.backward()
        ref.update()
    ta, ja = fused.get_params()[0], ref.get_params()[0]
    assert set(ta) == set(ja) == set(rnn_weights())
    for name in ja:
        _close(ta[name].asnumpy(), ja[name].asnumpy(), name, rtol=1e-4,
               atol=1e-4)


def test_dropout_in_a_foreach_body_draws_a_fresh_mask_each_step():
    """Training, p = 0.5 on ones: every step keeps about half (within 5
    standard errors) at 2, and no two steps share their mask."""
    s = tmx.sym
    o, _ = tmx.sym.contrib.foreach(
        lambda xt, st: (s.Dropout(xt, p=0.5) + st * 0, st),
        s.var("x"), s.var("st"))
    ex = o.simple_bind(ctx=tmx.cpu(), grad_req="null", x=(6, 400),
                       st=(400,))
    tmx.random.seed(11)
    y = ex.forward(is_train=True, x=np.ones((6, 400), np.float32),
                   st=np.zeros(400, np.float32))[0].asnumpy()
    assert set(np.unique(y)) <= {0.0, 2.0}
    kept = (y != 0).mean(axis=1)
    assert (np.abs(kept - 0.5) < 5 * np.sqrt(0.25 / 400)).all(), kept
    masks = {tuple(row) for row in (y != 0)}
    assert len(masks) == 6
    inference = ex.forward(is_train=False, x=np.ones((6, 400), np.float32),
                           st=np.zeros(400, np.float32))[0].asnumpy()
    np.testing.assert_array_equal(inference, np.ones((6, 400)))
