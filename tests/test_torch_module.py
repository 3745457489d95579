"""The PyTorch port's Module stack (`mxtpu_torch/module/`, `model.py`,
`optimizer/`, `io/`, `metric.py`) against the JAX package's: ResNet-18
v1 trained for three SGD-with-momentum steps from the same parameters,
the Module API around it, `fit`/`score`/`predict`, the optimizer's
arithmetic, the iterator and the metrics.

ResNet-18 v1 is traced by `mxtpu` at batch 4 and 3x64x64 (its last
stage is 2x2) with bench.py's head, learning rate 0.01 and momentum 0.9.
After each step the outputs must agree to a relative L2 of 1e-4, every
parameter to 1e-3 and every BN moving stat to 1e-4.

The initial state is drawn with numpy (Xavier-uniform weights, as
bench.py's initializer draws them) and copied into both.  The reference
is run with its BatchNorm statistics computed in two passes
(`_single_pass_stats(force=False)`: the same batch mean and biased
variance).  Its own training-mode form, E[x^2] - E[x]^2 in one float32
pass, cancels where the mean is large against the spread: against the
same network in float64 it moves the early gradients by up to a few
percent (relative L2; `test_resnet18_gradients_against_float64` records
it), so three steps would hold the port to that rounding.  The port
computes the statistics with `torch.var_mean`; both it and the two-pass
reference stay within 1e-4 of float64 at this shape (that test).
"""
import numpy as np
import pytest

import mxtpu as jmx
import mxtpu.ops.nn as jnn
from mxtpu import sym as jsym
from mxtpu.gluon.model_zoo import vision
import mxtpu_torch as tmx
from mxtpu_torch.base import MXNetError
import torch

torch.set_num_threads(1)

B, HW = 4, 64
OUT_TOL, PARAM_TOL, AUX_TOL = 1e-4, 1e-3, 1e-4


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def resnet18_json():
    with jsym.NameManager():
        net = vision.resnet18_v1(classes=10)
        net.initialize(jmx.init.Zero(), ctx=jmx.cpu())
        out, _, _ = net._trace_symbol(jmx.nd.zeros((B, 3, HW, HW),
                                                   ctx=jmx.cpu()))
        return jsym.SoftmaxOutput(data=out,
                                  label=jsym.Variable("softmax_label"),
                                  name="softmax").tojson()


def _module(mx, symbol, batch=B, **kw):
    mod = mx.mod.Module(symbol, data_names=("data0",),
                        label_names=("softmax_label",), context=mx.cpu(),
                        **kw)
    mod.bind(data_shapes=[("data0", (batch, 3, HW, HW))],
             label_shapes=[("softmax_label", (batch,))])
    return mod


def _batch(mx, x, y):
    return mx.io.DataBatch(data=[mx.nd.array(x, ctx=mx.cpu())],
                           label=[mx.nd.array(y, ctx=mx.cpu())])


def _xavier_params(symbol, rng):
    """Xavier-uniform weights, zero biases and betas, unit gammas, zero
    moving means and unit moving variances, drawn with numpy: the
    initial state both packages copy in."""
    arg_shapes, _, aux_shapes = symbol.infer_shape(
        data0=(B, 3, HW, HW), softmax_label=(B,))
    args = {}
    for n, s in zip(symbol.list_arguments(), arg_shapes):
        if n.endswith("weight"):
            hw = float(np.prod(s[2:]))
            lim = np.sqrt(3.0 / ((s[0] * hw + s[1] * hw) / 2.0))
            args[n] = rng.uniform(-lim, lim, s).astype(np.float32)
        elif n.endswith("gamma"):
            args[n] = np.ones(s, np.float32)
        elif n not in ("data0", "softmax_label"):
            args[n] = np.zeros(s, np.float32)
    aux = {n: (np.ones if n.endswith("var") else np.zeros)(s, np.float32)
           for n, s in zip(symbol.list_auxiliary_states(), aux_shapes)}
    return args, aux


def _nd(mx, arrays):
    return {k: mx.nd.array(v, ctx=mx.cpu()) for k, v in arrays.items()}


def test_resnet18_three_sgd_steps_match_the_reference(resnet18_json,
                                                      monkeypatch):
    two_pass = jnn._single_pass_stats
    monkeypatch.setattr(jnn, "_single_pass_stats",
                        lambda jnp, x, axes, keepdims=False, force=False:
                        two_pass(jnp, x, axes, keepdims, force=False))
    rng = np.random.RandomState(0)
    x = rng.rand(B, 3, HW, HW).astype(np.float32)
    y = rng.randint(0, 10, (B,)).astype(np.float32)
    opt = {"learning_rate": 0.01, "momentum": 0.9}
    jm, tm = (_module(mx, mx.sym.load_json(resnet18_json))
              for mx in (jmx, tmx))
    args, aux = _xavier_params(jm.symbol, rng)
    for mx, mod in ((jmx, jm), (tmx, tm)):
        mod.init_params(arg_params=_nd(mx, args), aux_params=_nd(mx, aux))
        mod.init_optimizer(optimizer="sgd", optimizer_params=opt)
    assert tm._optimizer.rescale_grad == jm._optimizer.rescale_grad == 1 / B
    jb, tb = _batch(jmx, x, y), _batch(tmx, x, y)
    for step in range(3):
        for mod, b in ((jm, jb), (tm, tb)):
            mod.forward(b, is_train=True)
            mod.backward()
            mod.update()
        out = _rel(tm.get_outputs()[0].asnumpy(),
                   jm.get_outputs()[0].asnumpy())
        assert out <= OUT_TOL, (step, out)
        (ja, jx), (ta, tx) = jm.get_params(), tm.get_params()
        assert set(ta) == set(ja) and set(tx) == set(jx)
        worst = max((_rel(ta[k].asnumpy(), ja[k].asnumpy()), k) for k in ja)
        assert worst[0] <= PARAM_TOL, (step, worst)
        for k in jx:
            assert _rel(tx[k].asnumpy(), jx[k].asnumpy()) <= AUX_TOL, k
            if k.endswith("_var"):
                assert np.all(tx[k].asnumpy() > 0), k
    moved = [k for k in tx if not np.allclose(tx[k].asnumpy(), aux[k])]
    assert len(moved) == len(tx)


def _grads(mx, symbol, args, aux, x, y, dtype="float32"):
    """One training forward and backward of a bound executor: every
    parameter's gradient, in float64."""
    ex = symbol.simple_bind(ctx=mx.cpu(), grad_req="write",
                            type_dict={n: dtype for n in
                                       symbol.list_arguments()},
                            data0=x.shape, softmax_label=y.shape)
    ex.copy_params_from(_nd(mx, dict(args, data0=x, softmax_label=y)),
                        _nd(mx, aux))
    ex.forward(is_train=True)
    ex.backward()
    return {k: ex.grad_dict[k].asnumpy().astype(np.float64) for k in args}


def test_resnet18_gradients_against_float64(resnet18_json, monkeypatch,
                                            record_property):
    """The port's float32 gradients of one training step against the
    same graph in float64 (the port's ops run in float64 there): within
    1e-4 for every parameter; so are the reference's, with its
    statistics in two passes.  The reference's single-pass deviation is
    recorded (``single_pass_worst_rel_l2``), not held to a bound."""
    rng = np.random.RandomState(0)
    x = rng.rand(B, 3, HW, HW).astype(np.float32)
    y = rng.randint(0, 10, (B,)).astype(np.float32)
    tsym = tmx.sym.load_json(resnet18_json)
    args, aux = _xavier_params(tsym, rng)
    exact = _grads(tmx, tsym, args, aux, x, y, "float64")

    def worst(grads):
        return max((_rel(grads[k], exact[k]), k) for k in exact)

    port = worst(_grads(tmx, tsym, args, aux, x, y))
    single = worst(_grads(jmx, jsym.load_json(resnet18_json), args, aux,
                          x, y))
    two_pass = jnn._single_pass_stats
    monkeypatch.setattr(jnn, "_single_pass_stats",
                        lambda jnp, x, axes, keepdims=False, force=False:
                        two_pass(jnp, x, axes, keepdims, force=False))
    ref = worst(_grads(jmx, jsym.load_json(resnet18_json), args, aux, x, y))
    record_property("single_pass_worst_rel_l2", single)
    assert port[0] <= 1e-4, port
    assert ref[0] <= 1e-4, ref


def _mlp(sym):
    data = sym.Variable("data")
    h = sym.Activation(sym.FullyConnected(data, num_hidden=16, name="fc1"),
                       act_type="relu", name="relu1")
    h = sym.BatchNorm(h, fix_gamma=False, eps=1e-5, name="bn1")
    return sym.SoftmaxOutput(sym.FullyConnected(h, num_hidden=3,
                                                name="fc2"), name="softmax")


def _mlp_data(n=48, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 6).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.float32) + (x[:, 1] > 0.5)
    return x, y.astype(np.float32)


def _params(mx, sym):
    arg_shapes, _, aux_shapes = sym.infer_shape(data=(8, 6),
                                                softmax_label=(8,))
    rng = np.random.RandomState(1)
    args = {n: rng.randn(*s).astype(np.float32) * 0.3
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}
    aux = {n: np.ones(s, np.float32) if n.endswith("var")
           else np.zeros(s, np.float32)
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, aux


def test_fit_score_and_predict_match_the_reference():
    x, y = _mlp_data()
    args, aux = _params(jmx, _mlp(jsym))
    res = {}
    for mx in (tmx, jmx):
        it = mx.io.NDArrayIter(x, y, batch_size=8, shuffle=False,
                               **({"ctx": mx.cpu()} if mx is tmx else {}))
        mod = mx.mod.Module(_mlp(mx.sym), context=mx.cpu())
        mod.fit(it, num_epoch=2, optimizer="sgd", arg_params=_nd(mx, args),
                aux_params=_nd(mx, aux),
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9,
                                  "wd": 1e-3})
        score = dict(mod.score(it, ["acc", "ce"]))
        pred = mod.predict(it).asnumpy()
        a, x_ = mod.get_params()
        res[mx] = (score, pred, {k: v.asnumpy() for k, v in a.items()},
                   {k: v.asnumpy() for k, v in x_.items()})
    (ts, tp, ta, tx), (js, jp, ja, jx) = res[tmx], res[jmx]
    assert tp.shape == jp.shape == (48, 3)
    assert _rel(tp, jp) <= OUT_TOL
    for k in ja:
        assert _rel(ta[k], ja[k]) <= PARAM_TOL, k
    for k in jx:
        assert _rel(tx[k], jx[k]) <= AUX_TOL, k
    assert ts["accuracy"] == js["accuracy"]
    assert abs(ts["cross-entropy"] - js["cross-entropy"]) <= 1e-4


def test_checkpoint_round_trip_with_the_reference(tmp_path):
    args, aux = _params(jmx, _mlp(jsym))
    mod = tmx.mod.Module(_mlp(tmx.sym), context=tmx.cpu())
    mod.bind(data_shapes=[("data", (8, 6))],
             label_shapes=[("softmax_label", (8,))])
    mod.init_params(arg_params=args, aux_params=aux)
    prefix = str(tmp_path / "mlp")
    mod.save_checkpoint(prefix, 3)
    sym, jargs, jaux = jmx.model.load_checkpoint(prefix, 3)
    assert sorted(jargs) == sorted(args) and sorted(jaux) == sorted(aux)
    for k in args:
        np.testing.assert_array_equal(jargs[k].asnumpy(), args[k])
    jmx.model.save_checkpoint(str(tmp_path / "ref"), 1, sym, jargs, jaux)
    back = tmx.mod.Module.load(str(tmp_path / "ref"), 1, context=tmx.cpu())
    back.bind(data_shapes=[("data", (8, 6))],
              label_shapes=[("softmax_label", (8,))])
    a, _ = back.get_params()
    for k in args:
        np.testing.assert_array_equal(a[k].asnumpy(), args[k])


def test_module_api():
    args, aux = _params(jmx, _mlp(jsym))
    mod = tmx.mod.Module(_mlp(tmx.sym), context=tmx.cpu(),
                         fixed_param_names=["fc1_bias"])
    with pytest.raises(MXNetError, match="bind"):
        mod.init_params()
    mod.bind(data_shapes=[("data", (8, 6))],
             label_shapes=[("softmax_label", (8,))])
    mod.init_params(arg_params=args, aux_params=aux)
    with pytest.raises(MXNetError, match="not ported .ROADMAP A15"):
        mod.init_optimizer(kvstore="tpu")
    mod.init_optimizer(optimizer="sgd")
    x, y = _mlp_data(8)
    mod.forward(_batch(tmx, x, y))
    mod.backward()
    mod.update()
    a, _ = mod.get_params()
    np.testing.assert_array_equal(a["fc1_bias"].asnumpy(), args["fc1_bias"])
    assert not np.array_equal(a["fc1_weight"].asnumpy(), args["fc1_weight"])
    # a batch of another size rebinds and keeps the updated parameters
    x4, y4 = _mlp_data(4, seed=2)
    mod.forward(_batch(tmx, x4, y4), is_train=False)
    assert mod.get_outputs()[0].shape == (4, 3)
    np.testing.assert_array_equal(mod.get_params()[0]["fc1_weight"]
                                  .asnumpy(), a["fc1_weight"].asnumpy())
    mod.set_params({k: v * 0 for k, v in args.items()}, aux)
    assert not mod.get_params()[0]["fc2_weight"].asnumpy().any()


def test_kvstore_device_on_one_device_trains_as_local():
    """On one device a kvstore name without "dist" other than "tpu"
    means no kvstore and a local update, as in the reference; "tpu"
    still raises (the "dist_*" stores: test_torch_dist_kvstore.py)."""
    args, aux = _params(jmx, _mlp(jsym))
    x, y = _mlp_data(8)
    got = {}
    for kv in ("local", "device"):
        mod = tmx.mod.Module(_mlp(tmx.sym), context=tmx.cpu())
        mod.bind(data_shapes=[("data", (8, 6))],
                 label_shapes=[("softmax_label", (8,))])
        mod.init_params(arg_params=args, aux_params=aux)
        mod.init_optimizer(kvstore=kv, optimizer_params={
            "learning_rate": 0.1, "momentum": 0.9})
        assert mod._kvstore is None
        for _ in range(2):
            mod.forward(_batch(tmx, x, y))
            mod.backward()
            mod.update()
        got[kv] = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    for k in got["local"]:
        np.testing.assert_array_equal(got["device"][k], got["local"][k])
        assert not np.array_equal(got["device"][k], args[k])
    for kv in ("tpu",):
        mod = tmx.mod.Module(_mlp(tmx.sym), context=tmx.cpu())
        mod.bind(data_shapes=[("data", (8, 6))],
                 label_shapes=[("softmax_label", (8,))])
        mod.init_params(arg_params=args, aux_params=aux)
        with pytest.raises(MXNetError, match="ROADMAP A15"):
            mod.init_optimizer(kvstore=kv)


@pytest.mark.parametrize("kw", [
    dict(learning_rate=0.1, momentum=0.9, wd=1e-2, rescale_grad=0.5),
    dict(learning_rate=0.05, momentum=0.0, wd=0.0, clip_gradient=0.1),
])
def test_sgd_fused_and_per_parameter_match_the_reference(kw):
    """The port's foreach step, its per-parameter step and the JAX
    package's SGD agree over three updates, with the wd multipliers of
    names that are not weights (bias: no decay)."""
    rng = np.random.RandomState(5)
    names = ["fc_weight", "fc_bias", "bn_gamma"]
    ws = [rng.randn(4, 3).astype(np.float32) for _ in names]
    gs = [[rng.randn(4, 3).astype(np.float32) for _ in names]
          for _ in range(3)]
    results = []
    for mx, fused in ((tmx, True), (tmx, False), (jmx, True)):
        opt = mx.optimizer.create("sgd", param_idx2name=dict(enumerate(names)),
                                  **kw)
        upd = mx.optimizer.get_updater(opt)
        w = [mx.nd.array(v, ctx=mx.cpu()) for v in ws]
        for step in gs:
            g = [mx.nd.array(v, ctx=mx.cpu()) for v in step]
            if fused:
                upd.update_multi([(i, g[i], w[i]) for i in range(3)])
            else:
                for i in range(3):
                    upd(i, g[i], w[i])
        results.append([v.asnumpy() for v in w])
        assert opt.num_update == 3
    for got in results[:2]:
        for a, b in zip(got, results[2]):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def test_metrics_match_the_reference():
    rng = np.random.RandomState(2)
    labels = [rng.randint(0, 4, (10,)).astype(np.float32) for _ in range(3)]
    preds = [rng.dirichlet(np.ones(4), 10).astype(np.float32)
             for _ in range(3)]
    for name in ("acc", "ce", ["acc", "ce"]):
        t, j = tmx.metric.create(name), jmx.metric.create(name)
        for lab, p in zip(labels, preds):
            t.update([tmx.nd.array(lab, ctx=tmx.cpu())],
                     [tmx.nd.array(p, ctx=tmx.cpu())])
            j.update([jmx.nd.array(lab, ctx=jmx.cpu())],
                     [jmx.nd.array(p, ctx=jmx.cpu())])
        for (tn, tv), (jn, jv) in zip(t.get_name_value(),
                                      j.get_name_value()):
            assert tn == jn and abs(tv - jv) <= 1e-6


def test_ndarray_iter_matches_the_reference():
    x, y = _mlp_data(10)
    for handle in ("pad", "discard"):
        t = tmx.io.NDArrayIter(x, y, batch_size=4, last_batch_handle=handle,
                               ctx=tmx.cpu())
        j = jmx.io.NDArrayIter(x, y, batch_size=4, last_batch_handle=handle)
        assert t.provide_data[0].shape == j.provide_data[0].shape
        tb, jb = list(t), list(j)
        assert len(tb) == len(jb)
        for a, b in zip(tb, jb):
            np.testing.assert_array_equal(a.data[0].asnumpy(),
                                          b.data[0].asnumpy())
            np.testing.assert_array_equal(a.label[0].asnumpy(),
                                          b.label[0].asnumpy())
            assert a.pad == b.pad
