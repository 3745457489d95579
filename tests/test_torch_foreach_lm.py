"""The word LM written with `sym.contrib.foreach`
(`test_torch_foreach_lm_net.py`) trained through the PyTorch port's
`Module` against the JAX package's, at vocabulary 50, width 16, 2
layers, T 5 and batch 4, from the same numpy weights: the softmax
outputs and every weight after each of 2 SGD steps within a relative L2
of 1e-5 (float32 sums in other orders over 5 steps and 2 layers).  The
same graph over the fused `RNN` op is held to the foreach graph in the
port (one step: the loss, every gradient and every updated weight within
1e-5), as `chip_smoke.py`'s cflow phase holds them on the card at full
width.
"""
import numpy as np
import pytest

import mxtpu as jmx
import mxtpu_torch as tmx
import test_torch_foreach_lm_net as lm
import torch

torch.set_num_threads(1)

VOCAB, WIDTH, LAYERS, BPTT, BATCH = 50, 16, 2, 5, 4
TOL = 1e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _steps(mx, make, steps=2):
    weights = lm.lm_weights(VOCAB, WIDTH, LAYERS)
    mod = lm.lm_module(mx, make(mx, VOCAB, WIDTH, LAYERS), VOCAB, WIDTH,
                       LAYERS, BPTT, BATCH, weights, mx.cpu())
    outs, params = [], []
    for x, y in lm.lm_batches(VOCAB, BPTT, BATCH, steps):
        mod.forward(lm.lm_data_batch(mx, x, y, WIDTH, LAYERS, mx.cpu()),
                    is_train=True)
        mod.backward()
        mod.update()
        outs.append((mod.get_outputs()[0].asnumpy(), y))
        params.append({k: v.asnumpy() for k, v in
                       mod.get_params()[0].items()})
    return outs, params


def test_foreach_lm_module_steps_match_the_reference():
    (to, tp), (jo, jp) = _steps(tmx, lm.foreach_lm), \
        _steps(jmx, lm.foreach_lm)
    for step in range(2):
        assert to[step][0].shape == (BPTT * BATCH, VOCAB)
        assert _rel(to[step][0], jo[step][0]) <= TOL, step
        assert set(tp[step]) == set(jp[step]) == \
            set(lm.weight_shapes(VOCAB, WIDTH, LAYERS))
        for k in jp[step]:
            assert _rel(tp[step][k], jp[step][k]) <= TOL, (step, k)
    first = lm.cross_entropy(*to[0])
    assert abs(first - np.log(VOCAB)) < 0.1  # near-uniform at the start


def _one_step(make):
    weights = lm.lm_weights(VOCAB, WIDTH, LAYERS)
    mod = lm.lm_module(tmx, make(tmx, VOCAB, WIDTH, LAYERS), VOCAB, WIDTH,
                       LAYERS, BPTT, BATCH, weights, tmx.cpu())
    x, y = lm.lm_batches(VOCAB, BPTT, BATCH, 1)[0]
    mod.forward(lm.lm_data_batch(tmx, x, y, WIDTH, LAYERS, tmx.cpu()),
                is_train=True)
    mod.backward()
    ex = mod._exec_group.execs[0]
    grads = {k: ex.grad_dict[k].asnumpy() for k in weights}
    probs = mod.get_outputs()[0].asnumpy()
    mod.update()
    return lm.cross_entropy(probs, y), grads, \
        {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def test_foreach_lm_equals_the_fused_rnn_graph():
    fl, fg, fw = _one_step(lm.foreach_lm)
    rl, rg, rw = _one_step(lm.fused_lm)
    assert abs(fl - rl) <= TOL * abs(rl)
    assert set(fg) == set(rg)
    for k in rg:
        assert _rel(fg[k], rg[k]) <= TOL, k
        assert _rel(fw[k], rw[k]) <= TOL, k


@pytest.mark.parametrize("make", [lm.foreach_lm, lm.fused_lm])
def test_the_lm_graphs_infer_their_weights(make):
    shapes = dict(data=(BATCH, BPTT), softmax_label=(BATCH, BPTT),
                  **{n: (BATCH, WIDTH) for n in lm.begin_names(LAYERS)})
    for mx in (tmx, jmx):
        sym = make(mx, VOCAB, WIDTH, LAYERS)
        args, outs, _ = sym.infer_shape(**shapes)
        got = dict(zip(sym.list_arguments(), args))
        for k, s in lm.weight_shapes(VOCAB, WIDTH, LAYERS).items():
            assert tuple(got[k]) == s, (mx.__name__, k, got[k])
        assert tuple(outs[0]) == (BPTT * BATCH, VOCAB)


def _named_twice(mx):
    """Two FullyConnected layers whose weights are two variable nodes of
    one name, "w": in MXNet, and in the JAX package, one parameter."""
    s = mx.sym
    a = s.FullyConnected(s.var("data"), weight=s.var("w"), no_bias=True,
                         num_hidden=3, name="fc1")
    b = s.FullyConnected(a, weight=s.var("w"), no_bias=True, num_hidden=3,
                         name="fc2")
    return s.MakeLoss(s.sum(b * b))


def _twice_module(mx, fused=False):
    x = np.random.RandomState(0).randn(2, 3).astype(np.float32)
    w = np.random.RandomState(1).randn(3, 3).astype(np.float32) * 0.5
    mod = mx.mod.Module(_named_twice(mx), data_names=("data",),
                        label_names=None, context=mx.cpu())
    mod.bind(data_shapes=[("data", (2, 3))])
    mod.init_params(arg_params={"w": mx.nd.array(w, ctx=mx.cpu())})
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": 0.01, "momentum": 0.9})
    batches = [mx.io.DataBatch(data=[mx.nd.array(x * (k + 1), ctx=mx.cpu())],
                               label=None) for k in range(3)]
    if fused:
        mx.FusedTrainLoop(mod, steps_per_program=3).run(batches)
    else:
        for b in batches:
            mod.forward(b, is_train=True)
            mod.backward()
            mod.update()
    return mod.get_params()[0]["w"].asnumpy()


@pytest.mark.parametrize("fused", [False, True])
def test_a_parameter_named_twice_is_updated_once_a_step(fused):
    """C8: the port's Module listed such a parameter twice and applied
    the optimizer to it twice a step (and FusedTrainLoop trained both
    positions, one of which the graph never reads); the JAX package
    updates it once.  Three SGD steps with momentum agree to 1e-5."""
    want = _twice_module(jmx)
    assert _rel(_twice_module(tmx, fused), want) <= TOL
