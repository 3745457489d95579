"""The PyTorch port's control flow (`mxtpu_torch/control_flow.py`, the
ops `_foreach`, `_while_loop` and `_cond` of
`mxtpu_torch/ops/control_flow.py`) against the JAX package's
(`mxtpu/control_flow.py`, `mxtpu/ops/control_flow.py`).

The seven cases of `tests/test_control_flow.py`, run in both packages on
the same numpy inputs: outputs, and the gradients of the outputs
weighted by the same head gradient (`jax.vjp` in the reference's
executor, torch's autograd in the port's), within float32's bound
(rtol 1e-5, atol 1e-5 times the largest magnitude of the reference
value; the trained foreach RNN within 1e-4 after 3 SGD steps at lr
0.5).  Also: `infer_shape` of each node; the while loop's missing
gradient; `tojson` of a control-flow graph.  The aux write-back, the
masked paths of a CUDA-graph capture, gluon and FusedTrainLoop are in
`test_torch_control_flow_b.py`.
"""
import numpy as np
import pytest

import mxtpu as jmx
import mxtpu_torch as tmx
from mxtpu_torch.base import MXNetError
import torch

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-5


def _close(got, want, what, rtol=RTOL, atol=ATOL):
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(np.asarray(got, np.float64), want,
                               rtol=rtol, atol=atol * scale, err_msg=what)


def _nd(mx, x):
    return mx.nd.array(x, ctx=mx.cpu())


def _both(fn):
    """fn(mx) for the port and the reference: (port's, reference's)."""
    return fn(tmx), fn(jmx)


def _grad_run(mx, symbol, args, grads, head_seed=7):
    """Outputs and the gradients of ``grads`` after one training forward
    and a backward seeded with normal heads (seed ``head_seed``)."""
    shapes = {k: v.shape for k, v in args.items()}
    req = {k: ("write" if k in grads else "null") for k in args}
    ex = symbol.simple_bind(ctx=mx.cpu(), grad_req=req, **shapes)
    outs = ex.forward(is_train=True, **args)
    rng = np.random.RandomState(head_seed)
    heads = [_nd(mx, rng.randn(*o.shape).astype(np.float32)) for o in outs]
    ex.backward(heads)
    return ([o.asnumpy() for o in outs],
            {k: ex.grad_dict[k].asnumpy() for k in grads})


def _check_grad_run(make, args, grads):
    (to, tg), (jo, jg) = _both(lambda mx: _grad_run(mx, make(mx), args,
                                                    grads))
    assert len(to) == len(jo)
    for k, (t, j) in enumerate(zip(to, jo)):
        _close(t, j, "output %d" % k)
    for name in grads:
        _close(tg[name], jg[name], "gradient of %s" % name)


# ---------------------------------------------------------------------------
# the seven cases of tests/test_control_flow.py, in both packages
# ---------------------------------------------------------------------------

def test_foreach_imperative_matches_numpy_and_the_reference():
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    w0 = np.random.RandomState(0).randn(4).astype(np.float32)

    def run(mx):
        data, w = _nd(mx, x), _nd(mx, w0)
        w.attach_grad()
        with mx.autograd.record():
            outs, fin = mx.nd.contrib.foreach(
                lambda xt, s: (xt * w + s, xt * w + s), data,
                mx.nd.zeros((4,), ctx=mx.cpu()))
            loss = (outs * outs).sum() + fin.sum()
        loss.backward()
        return outs.asnumpy(), fin.asnumpy(), w.grad.asnumpy()

    (to, tf, tg), (jo, jf, jg) = _both(run)
    exp = np.cumsum(x * w0, axis=0)
    _close(to, exp, "outputs against numpy")
    _close(to, jo, "outputs")
    _close(tf, jf, "final state")
    _close(tg, jg, "gradient of w")


def test_foreach_symbolic_matches_the_imperative_and_the_reference():
    rng = np.random.RandomState(0)
    args = {"x": rng.randn(3, 2, 2).astype(np.float32),
            "st": rng.randn(2, 2).astype(np.float32),
            "w": rng.randn(2, 2).astype(np.float32)}

    def make(mx):
        s = mx.sym
        w = s.var("w")
        o, fin = mx.sym.contrib.foreach(
            lambda xt, st: (s.dot(xt, w) + st, s.dot(xt, w) + st),
            s.var("x"), s.var("st"))
        return s.Group([o, fin])

    _check_grad_run(make, args, ("x", "st", "w"))
    acc, outs = args["st"], []
    for t in range(3):
        acc = args["x"][t] @ args["w"] + acc
        outs.append(acc)
    got = make(tmx).bind(ctx=tmx.cpu(), args={
        k: _nd(tmx, v) for k, v in args.items()}).forward()[0]
    _close(got.asnumpy(), np.stack(outs), "outputs against numpy")


def test_foreach_gradient_by_step():
    """x_t * h over 4 steps, h doubling each step, x = 2: d/dx_t is 1, 2,
    4, 8 and d/dh0 is 30 in both packages."""
    def make(mx):
        s = mx.sym
        return mx.sym.contrib.foreach(
            lambda xt, h: (xt * h, h * 2), s.var("x"), s.var("h"))[0]

    def run(mx):
        ex = make(mx).simple_bind(ctx=mx.cpu(), x=(4,), h=(1,),
                                  grad_req={"x": "write", "h": "write"})
        ex.forward(is_train=True, x=np.full(4, 2, np.float32),
                   h=np.ones(1, np.float32))
        ex.backward(_nd(mx, np.ones((4, 1), np.float32)))
        return ex.grad_dict["x"].asnumpy(), ex.grad_dict["h"].asnumpy()

    (tx, th), (jx, jh) = _both(run)
    np.testing.assert_array_equal(tx, [1, 2, 4, 8])
    np.testing.assert_array_equal(th, [30])
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(th, jh)


def test_foreach_symbolic_gradient_matches_the_imperative_tape():
    rng = np.random.RandomState(1)
    xv = rng.randn(4, 3).astype(np.float32)
    wv = rng.randn(3, 3).astype(np.float32)

    def run(mx):
        s = mx.sym
        w = s.var("w")
        _, fin = mx.sym.contrib.foreach(
            lambda xt, st: (s.dot(xt, w) + st,) * 2, s.var("x"), s.var("st"))
        ex = s.sum(fin).simple_bind(
            ctx=mx.cpu(), x=(4, 3), st=(3,), w=(3, 3),
            grad_req={"w": "write", "x": "null", "st": "null"})
        ex.forward(is_train=True, x=xv, st=np.zeros(3, np.float32), w=wv)
        ex.backward()
        g_sym = ex.grad_dict["w"].asnumpy()
        wn = _nd(mx, wv)
        wn.attach_grad()
        with mx.autograd.record():
            st = mx.nd.zeros((3,), ctx=mx.cpu())
            for t in range(4):
                st = mx.nd.dot(_nd(mx, xv[t]), wn) + st
            loss = st.sum()
        loss.backward()
        return g_sym, wn.grad.asnumpy()

    (ts, ti), (js, _) = _both(run)
    _close(ts, ti, "symbolic against imperative", rtol=1e-4)
    _close(ts, js, "symbolic against the reference")


def test_while_loop_symbolic_and_imperative():
    def run_sym(mx):
        s = mx.sym
        outs, _ = mx.sym.contrib.while_loop(
            lambda i, a: i < 5, lambda i, a: (i * 2, [i + 1, a + i]),
            [s.var("i"), s.var("acc")], max_iterations=8)
        ex = outs[0].simple_bind(ctx=mx.cpu(), i=(1,), acc=(1,))
        return ex.forward(i=np.zeros(1, np.float32),
                          acc=np.zeros(1, np.float32))[0].asnumpy()

    t, j = _both(run_sym)
    np.testing.assert_array_equal(
        t, np.array([0, 2, 4, 6, 8, 0, 0, 0], np.float32).reshape(8, 1))
    np.testing.assert_array_equal(t, j)

    def run_nd(mx):
        o, fv = mx.nd.contrib.while_loop(
            lambda i: i < 3, lambda i: (i * 10, [i + 1]),
            [mx.nd.zeros((1,), ctx=mx.cpu())], max_iterations=5)
        return o.asnumpy(), fv[0].asnumpy()

    (to, tf), (jo, jf) = _both(run_nd)
    np.testing.assert_array_equal(to, [[0], [10], [20], [0], [0]])
    np.testing.assert_array_equal(tf, [3])
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_array_equal(tf, jf)


def test_while_loop_that_never_runs_gives_zero_rows():
    def run(mx):
        s = mx.sym
        outs, fin = mx.sym.contrib.while_loop(
            lambda i: i < 0, lambda i: (i * 3, [i + 1]), [s.var("i")],
            max_iterations=4)
        ex = s.Group([outs, fin[0]]).simple_bind(ctx=mx.cpu(), i=(1,))
        return [o.asnumpy() for o in ex.forward(i=np.array([4],
                                                           np.float32))]

    t, j = _both(run)
    np.testing.assert_array_equal(t[0], np.zeros((4, 1), np.float32))
    np.testing.assert_array_equal(t[1], [4])
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, b)


def test_cond_symbolic_and_imperative_with_gradients():
    """With pred 1 and then = a * 2, d/da is 2 and d/db 0; with pred 0
    and else = b + 1 the other way round, in both packages."""
    for p in (1.0, 0.0):
        args = {"p": np.full(1, p, np.float32),
                "a": np.full(3, 2, np.float32),
                "b": np.zeros(3, np.float32)}

        def make(mx):
            s = mx.sym
            return mx.sym.contrib.cond(s.var("p"), lambda: s.var("a") * 2,
                                       lambda: s.var("b") + 1)

        (to, tg), (jo, jg) = _both(lambda mx: _grad_run(
            mx, make(mx), args, ("a", "b")))
        np.testing.assert_array_equal(to[0], [4, 4, 4] if p else [1, 1, 1])
        np.testing.assert_array_equal(to[0], jo[0])
        for name in ("a", "b"):
            np.testing.assert_array_equal(tg[name], jg[name])

    def run(mx):
        r = mx.nd.contrib.cond(mx.nd.ones((1,), ctx=mx.cpu()),
                               lambda: mx.nd.ones((2,), ctx=mx.cpu()) * 7,
                               lambda: mx.nd.zeros((2,), ctx=mx.cpu()))
        return r.asnumpy()

    t, j = _both(run)
    np.testing.assert_array_equal(t, [7, 7])
    np.testing.assert_array_equal(t, j)


def test_cond_gradient_values():
    def run(mx, p):
        ex = mx.sym.contrib.cond(
            mx.sym.var("p"), lambda: mx.sym.var("a") * 2,
            lambda: mx.sym.var("b") + 1).simple_bind(
                ctx=mx.cpu(), grad_req={"a": "write", "b": "write",
                                        "p": "null"}, p=(1,), a=(3,), b=(3,))
        ex.forward(is_train=True, p=np.full(1, p, np.float32),
                   a=np.full(3, 2, np.float32), b=np.zeros(3, np.float32))
        ex.backward()
        return ex.grad_dict["a"].asnumpy(), ex.grad_dict["b"].asnumpy()

    for p, want in ((1.0, (2, 0)), (0.0, (0, 1))):
        t, j = run(tmx, p), run(jmx, p)
        np.testing.assert_array_equal(t[0], np.full(3, want[0]))
        np.testing.assert_array_equal(t[1], np.full(3, want[1]))
        np.testing.assert_array_equal(t[0], j[0])
        np.testing.assert_array_equal(t[1], j[1])


T, E, H, C, N = 6, 5, 16, 3, 48


def _rnn_data():
    rng = np.random.RandomState(0)
    y = rng.randint(0, C, N).astype(np.float32)
    x = rng.randn(N, T, E).astype(np.float32) * 0.1
    for n in range(N):
        x[n, :, int(y[n])] += 1.0
    return x, y


def rnn_net(mx):
    """The Elman RNN classifier of tests/test_control_flow.py, built
    with foreach."""
    sym = mx.sym
    xs = sym.transpose(sym.var("data"), axes=(1, 0, 2))

    def cell(xt, h):
        i2h = sym.FullyConnected(data=xt, num_hidden=H, name="i2h")
        h2h = sym.FullyConnected(data=h, num_hidden=H, name="h2h")
        hn = sym.Activation(data=i2h + h2h, act_type="tanh")
        return hn, hn

    _, h_last = mx.sym.contrib.foreach(cell, xs, sym.var("h0"))
    fc = sym.FullyConnected(data=h_last, num_hidden=C, name="out")
    return sym.SoftmaxOutput(data=fc, label=sym.var("softmax_label"),
                             name="softmax")


def rnn_weights(seed=3):
    rng = np.random.RandomState(seed)
    shapes = {"i2h_weight": (H, E), "i2h_bias": (H,), "h2h_weight": (H, H),
              "h2h_bias": (H,), "out_weight": (C, H), "out_bias": (C,)}
    return {k: (rng.randn(*s) * 0.3).astype(np.float32)
            for k, s in sorted(shapes.items())}


def rnn_module(mx, batch=16, lr=0.5):
    mod = mx.mod.Module(rnn_net(mx), data_names=("data", "h0"),
                        label_names=("softmax_label",), context=mx.cpu())
    mod.bind(data_shapes=[("data", (batch, T, E)), ("h0", (batch, H))],
             label_shapes=[("softmax_label", (batch,))])
    mod.init_params(arg_params={k: _nd(mx, v)
                                for k, v in rnn_weights().items()})
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": lr})
    return mod


def rnn_batches(mx, batch=16):
    x, y = _rnn_data()
    return [mx.io.DataBatch(
        data=[_nd(mx, x[i:i + batch]),
              _nd(mx, np.zeros((batch, H), np.float32))],
        label=[_nd(mx, y[i:i + batch])]) for i in range(0, N, batch)]


def test_rnn_via_foreach_trains_as_the_reference():
    """Three Module steps from the same weights agree with the
    reference's (1e-4), then twelve epochs train it past 0.8 accuracy."""
    mods = {}
    for mx in (tmx, jmx):
        mod = rnn_module(mx)
        for b in rnn_batches(mx):
            mod.forward(b, is_train=True)
            mod.backward()
            mod.update()
        mods[mx] = mod
    ta, ja = mods[tmx].get_params()[0], mods[jmx].get_params()[0]
    assert set(ta) == set(ja) == set(rnn_weights())
    for name in ja:
        _close(ta[name].asnumpy(), ja[name].asnumpy(), name, rtol=1e-4,
               atol=1e-4)
    mod, metric = mods[tmx], tmx.metric.create("acc")
    batches = rnn_batches(tmx)
    for epoch in range(11):
        metric.reset()
        for b in batches:
            mod.forward(b, is_train=True)
            mod.update_metric(metric, b.label)
            mod.backward()
            mod.update()
    assert metric.get()[1] > 0.8, metric.get()


def test_foreach_batchnorm_updates_the_outer_aux_as_the_reference():
    def run(mx):
        s = mx.sym

        def body(xt, st):
            return s.BatchNorm(data=xt, name="bn", fix_gamma=False), st + 1

        o, _ = mx.sym.contrib.foreach(body, s.var("x"), s.var("st"))
        ex = o.simple_bind(ctx=mx.cpu(), x=(4, 2, 3), st=(1,))
        xv = (np.random.RandomState(0).randn(4, 2, 3) * 3 + 5) \
            .astype(np.float32)
        mm0 = ex.aux_dict["bn_moving_mean"].asnumpy().copy()
        ex.forward(is_train=True, x=xv, st=np.zeros(1, np.float32))
        got = {k: v.asnumpy().copy() for k, v in ex.aux_dict.items()}
        out = ex.forward(is_train=False, x=xv,
                         st=np.zeros(1, np.float32))[0].asnumpy()
        return mm0, got, out

    (t0, t, to), (_, j, jo) = _both(run)
    assert not np.allclose(t0, t["bn_moving_mean"])
    assert set(t) == set(j) == {"bn_moving_mean", "bn_moving_var"}
    for name in j:
        _close(t[name], j[name], name)
    assert np.isfinite(to).all()
    _close(to, jo, "inference output")


# ---------------------------------------------------------------------------
# shapes, the missing gradient, JSON
# ---------------------------------------------------------------------------

def _shape_graphs(mx):
    s = mx.sym
    w = s.var("w")
    fe = mx.sym.contrib.foreach(
        lambda xt, st: (s.FullyConnected(xt, num_hidden=3, name="fc") + st,
                        s.dot(st, w)), s.var("x"), s.var("st"))
    wl = mx.sym.contrib.while_loop(
        lambda i, a: s.sum(i) < 5,
        lambda i, a: (s.FullyConnected(a, num_hidden=2, name="g"),
                      [i + 1, a * 2]), [s.var("i"), s.var("a")],
        max_iterations=6)
    # the subgraph's own inference solves what its graph fixes: here
    # u's declared shape gives t's weight and bias
    cd = mx.sym.contrib.cond(s.var("p"),
                             lambda: s.FullyConnected(s.var("u", shape=(2, 5)),
                                                      num_hidden=4,
                                                      name="t"),
                             lambda: s.var("v") * 2)
    return {"foreach": (s.Group([fe[0], fe[1]]), dict(x=(5, 2, 4),
                                                     st=(2, 3), w=(3, 3))),
            "while_loop": (s.Group(list(wl[0] if isinstance(wl[0], list)
                                        else [wl[0]]) + wl[1]),
                           dict(i=(1,), a=(2, 3))),
            "cond": (cd, dict(p=(1,), v=(2, 4)))}


@pytest.mark.parametrize("kind", ["foreach", "while_loop", "cond"])
def test_infer_shape_of_each_node_matches_the_reference(kind):
    (tg, tk), (jg, jk) = _shape_graphs(tmx)[kind], _shape_graphs(jmx)[kind]
    assert tg.list_arguments() == jg.list_arguments()
    assert tg.list_auxiliary_states() == jg.list_auxiliary_states()
    t, j = tg.infer_shape(**tk), jg.infer_shape(**jk)
    assert [list(map(tuple, x)) for x in t] == \
        [list(map(tuple, x)) for x in j]


def _while_grad(mx):
    s = mx.sym
    outs, fin = mx.sym.contrib.while_loop(
        lambda i, a: i < 5, lambda i, a: (i * s.var("w"), [i + 1,
                                                          a + i * s.var("w")]),
        [s.var("i"), s.var("acc")], max_iterations=8)
    ex = s.sum(fin[1]).simple_bind(
        ctx=mx.cpu(), i=(1,), acc=(1,), w=(1,),
        grad_req={"w": "write", "i": "null", "acc": "null"})
    ex.forward(is_train=True, i=np.zeros(1, np.float32),
               acc=np.zeros(1, np.float32), w=np.ones(1, np.float32))


def test_while_loop_backward_raises_in_both_packages():
    with pytest.raises(ValueError, match="Reverse-mode differentiation"):
        _while_grad(jmx)
    with pytest.raises(MXNetError, match="no gradient"):
        _while_grad(tmx)


def test_while_loop_without_gradients_runs_in_training():
    """Training without a gradient through the loop is allowed in both
    packages (the trip count 5, the sum 0 + 1 + ... + 4)."""
    def run(mx):
        s = mx.sym
        _, fin = mx.sym.contrib.while_loop(
            lambda i, a: i < 5, lambda i, a: (i, [i + 1, a + i]),
            [s.var("i"), s.var("acc")], max_iterations=8)
        ex = s.Group(fin).simple_bind(ctx=mx.cpu(), grad_req="null",
                                      i=(1,), acc=(1,))
        return [o.asnumpy() for o in ex.forward(
            is_train=True, i=np.zeros(1, np.float32),
            acc=np.zeros(1, np.float32))]

    t, j = _both(run)
    np.testing.assert_array_equal(t[1], [10])
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, b)


def test_tojson_of_a_control_flow_graph_raises_type_error():
    for mx in (tmx, jmx):
        o, _ = mx.sym.contrib.foreach(lambda xt, st: (xt + st, st),
                                      mx.sym.var("x"), mx.sym.var("st"))
        with pytest.raises(TypeError):
            o.tojson()


def test_foreach_over_an_empty_axis_gives_empty_outputs_and_the_states():
    def run(mx):
        s = mx.sym
        o, fin = mx.sym.contrib.foreach(
            lambda xt, st: (s.dot(xt, s.var("w")) * 2, st + 1),
            s.var("x"), s.var("st"))
        ex = s.Group([o, fin]).simple_bind(ctx=mx.cpu(), grad_req="null",
                                           x=(0, 2, 3), st=(2, 4),
                                           w=(3, 4))
        return [v.asnumpy() for v in ex.forward(
            x=np.zeros((0, 2, 3), np.float32),
            st=np.arange(8, dtype=np.float32).reshape(2, 4),
            w=np.ones((3, 4), np.float32))]

    t, j = _both(run)
    assert t[0].shape == j[0].shape == (0, 2, 4)
    np.testing.assert_array_equal(t[1], j[1])
