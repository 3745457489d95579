"""The PyTorch port's Executor and Module, second part, against the JAX
package's (`mxtpu/executor.py`, `mxtpu/module/`): `Executor.reshape`
and `output_dict`; `warmup` leaving every bound value, aux state and the
random state as they were; ragged inference under the pow2 bucket
policy (`_forward_bucketed`: padded to the bucket and cut back, or run
exact where an output does not carry the batch); Module's ragged path,
which feeds this batch's labels and does not rebind; and
`get_input_grads`, `iter_predict`, `prepare` and `output_shapes`.

Tolerance: float32's (rtol 1e-4, atol 1e-5 times the largest magnitude
of the reference) against the JAX package.  A padded forward against
the exact one at the batch's own size: rtol 1e-5, atol 1e-6 times the
largest magnitude, since a convolution at another batch size may take
another algorithm (the JAX package's padded and exact outputs are not
bitwise equal either: its seed failure
`tests/test_compile_cache.py::test_bucketed_outputs_match_unbucketed`).
"""
import numpy as np
import pytest
import torch

import mxtpu as jmx
import mxtpu_torch as tmx
from mxtpu_torch.base import MXNetError

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
PAD_RTOL, PAD_ATOL = 1e-5, 1e-6
B = 8


def _close(got, want, what="", rtol=RTOL, atol=ATOL):
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol,
                               atol=atol * scale, err_msg=what)


def _convnet(mx, dropout=False):
    data = mx.sym.Variable("data")
    c = mx.sym.Convolution(data, kernel=(3, 3), pad=(1, 1), num_filter=4,
                           name="c1")
    c = mx.sym.BatchNorm(c, fix_gamma=False, name="bn1")
    c = mx.sym.Activation(c, act_type="relu", name="r1")
    if dropout:
        c = mx.sym.Dropout(c, p=0.5, name="drop")
    c = mx.sym.Pooling(c, kernel=(2, 2), stride=(2, 2), pool_type="max",
                       name="p1")
    f = mx.sym.FullyConnected(c, num_hidden=3, name="fc")
    return mx.sym.SoftmaxOutput(f, name="softmax")


def _args(symbol, batch, seed=0):
    shapes, _, aux_shapes = symbol.infer_shape(data=(batch, 2, 6, 6),
                                               softmax_label=(batch,))
    rng = np.random.RandomState(seed)
    args = {n: (rng.randn(*s) * 0.5).astype(np.float32)
            for n, s in zip(symbol.list_arguments(), shapes)}
    args["softmax_label"] = rng.randint(0, 3, batch).astype(np.float32)
    aux = {n: (rng.rand(*s) + 0.5).astype(np.float32)
           for n, s in zip(symbol.list_auxiliary_states(), aux_shapes)}
    return args, aux


def _bind(mx, symbol, args, aux, grad_req="write"):
    ex = symbol.simple_bind(mx.cpu(), grad_req=grad_req,
                            **{n: v.shape for n, v in args.items()
                               if n in ("data", "softmax_label")})
    for n, v in args.items():
        ex.arg_dict[n][:] = v
    for n, v in aux.items():
        ex.aux_dict[n][:] = v
    return ex


def _state(ex):
    return ([a.asnumpy().copy() for a in ex.arg_arrays],
            [a.asnumpy().copy() for a in ex.aux_arrays],
            [g.asnumpy().copy() for g in ex.grad_arrays if g is not None])


def test_reshape_and_output_dict_match_the_reference():
    got = []
    for mx in (tmx, jmx):
        symbol = _convnet(mx)
        args, aux = _args(symbol, B)
        ex = _bind(mx, symbol, args, aux)
        new = ex.reshape(data=(3, 2, 6, 6), softmax_label=(3,))
        assert new is not ex
        assert new.arg_dict["data"].shape == (3, 2, 6, 6)
        assert ex.arg_dict["data"].shape == (B, 2, 6, 6)
        for n in ("c1_weight", "fc_weight", "fc_bias"):
            np.testing.assert_array_equal(new.arg_dict[n].asnumpy(), args[n])
        for n, v in aux.items():
            np.testing.assert_array_equal(new.aux_dict[n].asnumpy(), v)
        assert new.grad_dict["c1_weight"] is not None
        new.arg_dict["data"][:] = args["data"][:3]
        new.arg_dict["softmax_label"][:] = args["softmax_label"][:3]
        outs = new.forward(is_train=True)
        new.backward()
        assert list(new.output_dict) == symbol.list_outputs()
        assert new.output_dict["softmax_output"] is outs[0]
        got.append((outs[0].asnumpy(),
                    new.grad_dict["c1_weight"].asnumpy()))
    _close(got[0][0], got[1][0], "output")
    _close(got[0][1], got[1][1], "gradient")


@pytest.mark.parametrize("dropout", [False, True])
def test_warmup_changes_nothing(dropout):
    symbol = _convnet(tmx, dropout)
    args, aux = _args(symbol, B)
    tmx.random.seed(11)
    ex = _bind(tmx, symbol, args, aux)
    twin = _bind(tmx, symbol, args, aux)
    ex.forward(is_train=True)
    ex.backward()
    before = _state(ex)
    rng_state = tmx.random.get_state()
    assert ex.warmup() is ex
    assert ex._has_rng == dropout
    for a, b in zip(_state(ex), before):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert tmx.random.get_state()["seed"] == rng_state["seed"]
    # the draws after warmup are the draws without it
    outs = ex.forward(is_train=True)[0].asnumpy()
    tmx.random.set_state(rng_state)
    twin_outs = twin.forward(is_train=True)[0].asnumpy()
    np.testing.assert_array_equal(outs, twin_outs)
    inference = _bind(tmx, symbol, args, aux, grad_req="null")
    assert inference.warmup() is inference


def _ragged_outputs(mx, symbol, args, aux, sizes, kw):
    ex = _bind(mx, symbol, args, aux, grad_req="null")
    rng = np.random.RandomState(3)
    out = {}
    for b in sizes:
        x = rng.randn(b, 2, 6, 6).astype(np.float32)
        outs = ex.forward(is_train=False, data=mx.nd.array(x, **kw))
        out[b] = (x, [o.asnumpy() for o in outs])
    # the bound arrays are untouched
    np.testing.assert_array_equal(ex.arg_dict["data"].asnumpy(),
                                  args["data"])
    return out


def _two_heads(mx):
    """The class scores (batch-major) and a statistic of the whole batch
    (not batch-major): the second output forbids padding."""
    internals = _convnet(mx).get_internals()
    feat = internals["fc_output"]
    total = mx.sym.sum(internals["data"], axis=(0, 2, 3), name="total")
    return mx.sym.Group([mx.sym.softmax(feat, name="prob"), total])


@pytest.mark.parametrize("graph", ["convnet", "two_heads"])
def test_ragged_inference_matches_the_reference(monkeypatch, graph):
    monkeypatch.setenv("MXTPU_SHAPE_BUCKETS", "pow2")
    sizes = (1, 3, 5, 6, 7)
    got = {}
    for mx in (tmx, jmx):
        kw = dict(ctx=mx.cpu()) if mx is tmx else {}
        symbol = _convnet(mx) if graph == "convnet" else _two_heads(mx)
        args, aux = _args(_convnet(mx), B)
        if graph == "two_heads":
            args.pop("softmax_label")
        got[mx] = _ragged_outputs(mx, symbol, args, aux, sizes, kw)
    symbol = _convnet(tmx) if graph == "convnet" else _two_heads(tmx)
    for b in sizes:
        x, t_outs = got[tmx][b]
        _, j_outs = got[jmx][b]
        # the exact forward: the same graph bound at this batch's size
        args, aux = _args(_convnet(tmx), B)
        exact_args = dict(args, data=x)
        if graph == "two_heads":
            exact_args.pop("softmax_label")
        else:
            exact_args["softmax_label"] = args["softmax_label"][:b]
        exact = _bind(tmx, symbol, exact_args, aux, grad_req="null")
        e_outs = [o.asnumpy() for o in exact.forward(is_train=False)]
        for t, j, e in zip(t_outs, j_outs, e_outs):
            assert t.shape == j.shape == e.shape
            assert graph == "two_heads" or t.shape[0] == b
            _close(t, j, "against mxtpu, batch %d" % b)
            _close(t, e, "against the exact forward, batch %d" % b,
                   PAD_RTOL, PAD_ATOL)


def test_ragged_inference_needs_a_bucket_policy(monkeypatch):
    monkeypatch.delenv("MXTPU_SHAPE_BUCKETS", raising=False)
    symbol = _convnet(tmx)
    args, aux = _args(symbol, B)
    ex = _bind(tmx, symbol, args, aux, grad_req="null")
    x = tmx.nd.zeros((3, 2, 6, 6), ctx=tmx.cpu())
    with pytest.raises(MXNetError, match="shape mismatch"):
        ex.forward(is_train=False, data=x)
    monkeypatch.setenv("MXTPU_SHAPE_BUCKETS", "pow2")
    with pytest.raises(MXNetError, match="shape mismatch"):
        ex.forward(is_train=True, data=x)


def _label_net(mx):
    """Scores plus the label: an output that reads this batch's labels."""
    data = mx.sym.Variable("data")
    label = mx.sym.Variable("softmax_label")
    f = mx.sym.FullyConnected(data, num_hidden=3, name="fc")
    return mx.sym.broadcast_add(f, mx.sym.reshape(label, shape=(-1, 1)),
                                name="plus")


def test_module_ragged_path_uses_this_batchs_labels(monkeypatch):
    monkeypatch.setenv("MXTPU_SHAPE_BUCKETS", "pow2")
    rng = np.random.RandomState(4)
    w = rng.randn(3, 5).astype(np.float32)
    b = rng.randn(3).astype(np.float32)
    got = []
    for mx in (tmx, jmx):
        kw = dict(ctx=mx.cpu()) if mx is tmx else {}
        mod = mx.mod.Module(_label_net(mx), context=mx.cpu())
        mod.bind(data_shapes=[("data", (B, 5))],
                 label_shapes=[("softmax_label", (B,))],
                 for_training=False)
        mod.init_params(arg_params={"fc_weight": mx.nd.array(w, **kw),
                                    "fc_bias": mx.nd.array(b, **kw)})
        group, execs = mod._exec_group, list(mod._exec_group.execs)
        outs = []
        for n in (3, 5, 8, 2):
            x = np.random.RandomState(n).randn(n, 5).astype(np.float32)
            y = np.arange(n, dtype=np.float32) * 10
            mod.forward(mx.io.DataBatch([mx.nd.array(x, **kw)],
                                        [mx.nd.array(y, **kw)]),
                        is_train=False)
            out = mod.get_outputs()[0].asnumpy()
            assert out.shape == (n, 3)
            _close(out, x @ w.T + b + y[:, None])
            outs.append(out)
        # no rebind: the same group and executor served every size
        assert mod._exec_group is group and mod._exec_group.execs == execs
        got.append(outs)
    for t, j in zip(*got):
        _close(t, j)


def test_module_without_a_policy_rebinds(monkeypatch):
    monkeypatch.delenv("MXTPU_SHAPE_BUCKETS", raising=False)
    mod = tmx.mod.Module(_label_net(tmx), context=tmx.cpu())
    mod.bind(data_shapes=[("data", (B, 5))],
             label_shapes=[("softmax_label", (B,))], for_training=False)
    mod.init_params()
    group = mod._exec_group
    mod.forward(tmx.io.DataBatch([tmx.nd.zeros((3, 5), ctx=tmx.cpu())],
                                 [tmx.nd.zeros((3,), ctx=tmx.cpu())]),
                is_train=False)
    assert mod._exec_group is not group
    assert mod.get_outputs()[0].shape == (3, 3)


def _module(mx, kw, inputs_need_grad=False, batch=4):
    symbol = _convnet(mx)
    args, aux = _args(symbol, batch, seed=5)
    mod = mx.mod.Module(symbol, context=mx.cpu())
    mod.bind(data_shapes=[("data", (batch, 2, 6, 6))],
             label_shapes=[("softmax_label", (batch,))],
             inputs_need_grad=inputs_need_grad)
    mod.init_params(arg_params={n: mx.nd.array(v, **kw)
                                for n, v in args.items()
                                if n not in ("data", "softmax_label")},
                    aux_params={n: mx.nd.array(v, **kw)
                                for n, v in aux.items()})
    return mod, args


def test_get_input_grads_and_output_shapes_match_the_reference():
    got = []
    for mx in (tmx, jmx):
        kw = dict(ctx=mx.cpu()) if mx is tmx else {}
        mod, args = _module(mx, kw, inputs_need_grad=True)
        if mx is tmx:
            # the port infers with the label shapes too; the JAX
            # package's output_shapes reads the data shapes only, which
            # cannot size SoftmaxOutput's label
            assert mod.output_shapes == [("softmax_output", (4, 3))]
        fc = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=7,
                                   name="fc")
        free = mx.mod.Module(fc, label_names=None, context=mx.cpu())
        free.bind(data_shapes=[("data", (4, 5))], for_training=False)
        assert [(n, tuple(s)) for n, s in free.output_shapes] == \
            [("fc_output", (4, 7))]
        mod.forward(mx.io.DataBatch([mx.nd.array(args["data"], **kw)],
                                    [mx.nd.array(args["softmax_label"],
                                                 **kw)]), is_train=True)
        mod.backward()
        (g,) = mod.get_input_grads()
        assert g.shape == (4, 2, 6, 6)
        got.append(g.asnumpy())
        plain, _ = _module(mx, kw)
        with pytest.raises(Exception):
            plain.get_input_grads()
    _close(*got)


def test_iter_predict_and_prepare_match_the_reference():
    rng = np.random.RandomState(6)
    x = rng.randn(10, 2, 6, 6).astype(np.float32)
    y = rng.randint(0, 3, 10).astype(np.float32)
    got = []
    for mx in (tmx, jmx):
        kw = dict(ctx=mx.cpu()) if mx is tmx else {}
        mod, _ = _module(mx, kw)
        it = mx.io.NDArrayIter(x, y, batch_size=4, **kw)
        assert mod.prepare(next(iter(it))) is None
        seen = [(nbatch, [o.asnumpy() for o in outs], batch.pad)
                for outs, nbatch, batch in mod.iter_predict(it)]
        assert [n for n, _, _ in seen] == [0, 1, 2]
        assert [o[0].shape[0] for _, o, _ in seen] == [4, 4, 2]
        merged = mod.predict(it).asnumpy()
        np.testing.assert_array_equal(
            merged, np.concatenate([o[0] for _, o, _ in seen]))
        got.append(seen)
    for (tn, to, tp), (jn, jo, jp) in zip(*got):
        assert (tn, tp) == (jn, jp)
        _close(to[0], jo[0])


def test_module_warmup_runs_and_keeps_the_parameters():
    mod, args = _module(tmx, dict(ctx=tmx.cpu()))
    before = {n: a.asnumpy().copy() for n, a in mod.get_params()[0].items()}
    assert mod.warmup() is mod
    after = mod.get_params()[0]
    for n, v in before.items():
        np.testing.assert_array_equal(after[n].asnumpy(), v)
    with pytest.raises(MXNetError):
        tmx.mod.Module(_convnet(tmx), context=tmx.cpu()).warmup()
