"""The PyTorch port's subgraph framework (`mxtpu_torch/subgraph.py`)
against the JAX package's (`mxtpu/subgraph.py`), case by case as
`tests/test_subgraph.py` holds `mxtpu`: the Conv+BN fold of backend
"TPU" (with and without the convolution's bias, and skipped where the
convolution has a second consumer), the generic `_subgraph_exec`
wrapping (forward and gradient; two external inputs found in another
order than the subgraph lists them), a wrapped region through
`save`/`load`, a non-convex region refused, the backend registry and
the `MXTPU_SUBGRAPH_BACKEND` bind hook, the AMP policy inside a wrapped
region, the quantization pass on the framework, and a random node
inside a wrapped region (by distribution: the port draws from its
generator where the JAX package folds a key a node).

Each case runs in both packages from the same numpy arrays: the
partitioned graphs hold the same nodes (op and name, in order), and
the outputs and gradients agree with `mxtpu`'s within `test_torch_ops`'s
bound (1e-5 relative plus 1e-6 of the largest magnitude), and with the
unpartitioned graph or the closed form within `tests/test_subgraph.py`'s
bounds.
"""
import numpy as np
import pytest
import torch

import mxtpu as jmx
import mxtpu.subgraph as jsg
import mxtpu_torch as tmx
import mxtpu_torch.subgraph as tsg
from test_torch_ops import close

torch.set_num_threads(1)

PACKAGES = ((jmx, jsg), (tmx, tsg))


def nd(mx, x):
    return mx.nd.array(x, ctx=mx.cpu())


def set_array(arr, x):
    if hasattr(arr, "_set_jax"):
        arr._set_jax(jmx.nd.array(x)._data)
    else:
        arr._set_data(torch.from_numpy(np.asarray(x)))


def graph_of(symbol):
    return [(n.name, None if n.is_variable else n.op.name)
            for n in symbol._topo()]


def conv_bn_net(mx, with_bias=False, two_convs=False):
    s = mx.sym
    conv = s.Convolution(s.Variable("data"), kernel=(3, 3), num_filter=8,
                         pad=(1, 1), no_bias=not with_bias, name="conv0")
    act = s.Activation(s.BatchNorm(conv, fix_gamma=False, name="bn0"),
                       act_type="relu", name="relu0")
    if two_convs:
        conv1 = s.Convolution(act, kernel=(1, 1), num_filter=4,
                              no_bias=True, name="conv1")
        act = s.Activation(s.BatchNorm(conv1, fix_gamma=True, name="bn1"),
                           act_type="relu", name="relu1")
    pool = s.Pooling(act, global_pool=True, pool_type="avg", name="pool0")
    return s.FullyConnected(pool.flatten(), num_hidden=10, name="fc0")


def random_params(net, data_shape):
    arg_shapes, _, aux_shapes = net.infer_shape(data=data_shape)
    rng = np.random.RandomState(0)
    args = {n: rng.uniform(-0.5, 0.5, s).astype(np.float32)
            for n, s in zip(net.list_arguments(), arg_shapes)
            if n != "data"}
    aux = {n: (rng.uniform(0.5, 2.0, s) if "var" in n
               else rng.uniform(-0.5, 0.5, s)).astype(np.float32)
           for n, s in zip(net.list_auxiliary_states(), aux_shapes)}
    return args, aux


def infer_forward(mx, net, args, aux, x):
    exe = net.simple_bind(ctx=mx.cpu(), grad_req="null", data=x.shape)
    exe.copy_params_from(args, aux, allow_extra_params=False)
    return exe.forward(is_train=False, data=nd(mx, x))[0].asnumpy()


def fold_both(make, shape):
    """(graph, folded args, folded aux, fold output, unfolded output) in
    each package."""
    x = np.random.RandomState(1).uniform(-1, 1, shape).astype(np.float32)
    out = []
    for mx, _ in PACKAGES:
        with mx.sym.NameManager():  # the same auto names in both
            net = make(mx)
        args, aux = random_params(net, shape)
        args = {k: nd(mx, v) for k, v in args.items()}
        aux = {k: nd(mx, v) for k, v in aux.items()}
        fsym, fargs, faux = net.optimize_for("TPU", args=args, aux=aux)
        out.append((graph_of(fsym),
                    {k: v.asnumpy() for k, v in fargs.items()},
                    sorted(faux), infer_forward(mx, fsym, fargs, faux, x),
                    infer_forward(mx, net, args, aux, x)))
    return out


@pytest.mark.parametrize("with_bias", [False, True])
def test_conv_bn_fold_matches(with_bias):
    want, got = fold_both(
        lambda mx: conv_bn_net(mx, with_bias=with_bias, two_convs=True),
        (2, 3, 8, 8))
    assert got[0] == want[0]
    assert "BatchNorm" not in [op for _, op in got[0]]
    assert sorted(got[1]) == sorted(want[1]) and got[2] == want[2] == []
    for k in want[1]:
        close(got[1][k], want[1][k], k)
    close(got[3], want[3], "folded output")
    np.testing.assert_allclose(got[3], got[4], rtol=2e-4, atol=2e-4)


def test_conv_bn_fold_skipped_when_conv_shared():
    def make(mx):
        s = mx.sym
        conv = s.Convolution(s.Variable("data"), kernel=(1, 1), num_filter=4,
                             no_bias=True, name="convS")
        return s.Pooling(s.BatchNorm(conv, name="bnS") + conv,
                         global_pool=True, pool_type="avg")

    want, got = fold_both(make, (1, 2, 4, 4))
    assert got[0] == want[0] and "BatchNorm" in [op for _, op in got[0]]
    close(got[3], want[3], "output")
    np.testing.assert_allclose(got[3], got[4], rtol=1e-5, atol=1e-6)


def wrap_act_chains(sg):
    """A property wrapping Activation (+ following elemwise) chains into
    `_subgraph_exec` nodes, in the package whose subgraph module is
    ``sg``."""
    class Sel(sg.SubgraphSelector):
        def select(self, node):
            return node.op.name == "Activation"

        def select_output(self, node, output_node):
            return output_node.op.name in ("elemwise_add", "elemwise_mul")

    class Prop(sg.SubgraphProperty):
        def create_selector(self):
            return Sel()
    return Prop


def test_generic_wrap_forward_and_gradient():
    rng = np.random.RandomState(3)
    x = rng.uniform(-1, 1, (3, 4)).astype(np.float32)
    wv = rng.uniform(-1, 1, (6, 4)).astype(np.float32)
    res = []
    for mx, sg in PACKAGES:
        s = mx.sym
        act = s.Activation(s.FullyConnected(s.Variable("data"),
                                            weight=s.Variable("w"),
                                            num_hidden=6, no_bias=True,
                                            name="fcW"),
                           act_type="tanh", name="actW")
        with mx.sym.NameManager():
            out = s.sum(act * act + act)
        psym = sg.partition_with_property(out, wrap_act_chains(sg)())
        runs = []
        for sym_ in (out, psym):
            exe = sym_.simple_bind(ctx=mx.cpu(), grad_req="write",
                                   data=x.shape)
            set_array(exe.arg_dict["w"], wv)
            o = exe.forward(is_train=True, data=nd(mx, x))[0].asnumpy()
            exe.backward()
            runs.append((o, exe.grad_dict["w"].asnumpy()))
        res.append((graph_of(psym), runs))
    (jg, jruns), (tg, truns) = res
    assert tg == jg and "_subgraph_exec" in [op for _, op in tg]
    assert "Activation" not in [op for _, op in tg]
    for (to, tgr), (jo, jgr) in zip(truns, jruns):
        close(to, jo, "output")
        close(tgr, jgr, "gradient")
    np.testing.assert_allclose(truns[1][0], truns[0][0], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(truns[1][1], truns[0][1], rtol=1e-5,
                               atol=1e-5)


def test_generic_wrap_permuted_external_inputs():
    x = np.random.RandomState(6).uniform(-1, 1, (2, 3)).astype(np.float32)
    outs = []
    for mx, sg in PACKAGES:
        s = mx.sym
        data = s.Variable("data")
        out = mx.sym.elemwise_add(data * 2.0, s.Activation(
            data, act_type="relu", name="actP"), name="addP")

        class Sel(sg.SubgraphSelector):
            def select(self, node):
                return node.name == "actP"

            def select_output(self, node, output_node):
                return output_node.name == "addP"

        class P(sg.SubgraphProperty):
            def create_selector(self):
                return Sel()

        psym = sg.partition_with_property(out, P())
        assert "_subgraph_exec" in [op for _, op in graph_of(psym)]
        outs.append(psym.bind(ctx=mx.cpu(), args={"data": nd(mx, x)})
                    .forward()[0].asnumpy())
    close(outs[1], outs[0], "output")
    np.testing.assert_allclose(outs[1], x * 2.0 + np.maximum(x, 0),
                               rtol=1e-5, atol=1e-6)


def test_wrapped_subgraph_survives_save_load(tmp_path):
    x = np.random.RandomState(4).uniform(-1, 1, (2, 3)).astype(np.float32)
    outs = []
    for k, (mx, sg) in enumerate(PACKAGES):
        act = mx.sym.Activation(mx.sym.Variable("data"), act_type="sigmoid",
                                name="actJ")
        with mx.sym.NameManager():
            twice = act + act
        psym = sg.partition_with_property(twice, wrap_act_chains(sg)())
        fn = str(tmp_path / ("sg%d.json" % k))
        psym.save(fn)
        loaded = mx.sym.load(fn)
        assert graph_of(loaded) == graph_of(psym)
        outs.append(loaded.bind(ctx=mx.cpu(), args={"data": nd(mx, x)})
                    .forward()[0].asnumpy())
    close(outs[1], outs[0], "output")
    np.testing.assert_allclose(outs[1], 2 / (1 + np.exp(-x)), rtol=1e-5,
                               atol=1e-6)
    # the JAX package's file binds in the port
    loaded = tmx.sym.load(str(tmp_path / "sg0.json"))
    close(loaded.bind(ctx=tmx.cpu(), args={"data": nd(tmx, x)})
          .forward()[0].asnumpy(), outs[0], "mxtpu's file in the port")


def test_non_convex_region_rejected():
    x = np.random.RandomState(5).uniform(-1, 1, (2, 2)).astype(np.float32)
    for mx, sg in PACKAGES:
        s = mx.sym
        a = s.Activation(s.Variable("data"), act_type="relu", name="nodeA")
        b = s.Activation(a, act_type="tanh", name="nodeB")
        d = mx.sym.elemwise_add(a, b, name="nodeD")
        names = {"nodeA", "nodeD"}

        class S(sg.SubgraphSelector):
            def select(self, node):
                return node.name in names

            def select_input(self, node, input_node):
                return input_node.name in names

            def select_output(self, node, output_node):
                return output_node.name in names

        class P(sg.SubgraphProperty):
            def create_selector(self):
                return S()

        psym = sg.partition_with_property(d, P())
        assert "_subgraph_exec" not in [op for _, op in graph_of(psym)]
        got = psym.bind(ctx=mx.cpu(), args={"data": nd(mx, x)}) \
            .forward()[0].asnumpy()
        r = np.maximum(x, 0)
        np.testing.assert_allclose(got, r + np.tanh(r), rtol=1e-5, atol=1e-6)


def test_backend_registry_and_bind_hook(monkeypatch):
    x = np.asarray([[-1.0, 2.0], [3.0, -4.0]], np.float32)
    for mx, sg in PACKAGES:
        assert "TPU" in sg.list_backends()
        name = "TEST_WRAP_ACT"
        if name not in sg.list_backends():
            sg.register_backend(name, wrap_act_chains(sg))
        with pytest.raises(mx.MXNetError):
            sg.register_backend(name, wrap_act_chains(sg))
        monkeypatch.setenv("MXTPU_SUBGRAPH_BACKEND", name)
        out = mx.sym.Activation(mx.sym.Variable("data"), act_type="relu",
                                name="actE") * 1.0
        exe = out.simple_bind(ctx=mx.cpu(), grad_req="null", data=(2, 2))
        assert "_subgraph_exec" in [op for _, op in graph_of(exe._symbol)]
        got = exe.forward(data=nd(mx, x))[0].asnumpy()
        np.testing.assert_allclose(got, np.maximum(x, 0))
        # a backend that rewrites parameters is refused by the hook
        monkeypatch.setenv("MXTPU_SUBGRAPH_BACKEND", "TPU")
        exe2 = out.simple_bind(ctx=mx.cpu(), grad_req="null", data=(2, 2))
        assert "_subgraph_exec" not in [op for _, op in
                                        graph_of(exe2._symbol)]
        monkeypatch.delenv("MXTPU_SUBGRAPH_BACKEND")
        with pytest.raises(mx.MXNetError):
            sg.get_backend("NO_SUCH_BACKEND")


def test_wrapped_region_honors_amp_policy():
    x = np.random.RandomState(7).uniform(-1, 1, (4, 8)).astype(np.float32)
    res = []
    for mx, sg in PACKAGES:
        class S(sg.SubgraphSelector):
            def select(self, node):
                return node.op.name == "FullyConnected"

        class WrapFC(sg.SubgraphProperty):
            def create_selector(self):
                return S()

        out = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=5,
                                    name="fcA")
        psym = sg.partition_with_property(out, WrapFC())
        assert "_subgraph_exec" in [op for _, op in graph_of(psym)]
        runs = []
        for sym_ in (out, psym):
            with mx.amp.scope("bfloat16"):
                exe = sym_.simple_bind(ctx=mx.cpu(), grad_req="null",
                                       data=(4, 8))
                for k, v in exe.arg_dict.items():
                    if k != "data":
                        set_array(v, np.random.RandomState(8).uniform(
                            -1, 1, v.shape).astype(np.float32))
                runs.append(exe.forward(data=nd(mx, x))[0].asnumpy()
                            .astype(np.float32))
        res.append(runs)
    (jref, jgot), (tref, tgot) = res
    np.testing.assert_allclose(tgot, tref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(jgot, jref, rtol=1e-6, atol=1e-6)
    # bfloat16 products: the port's within one bf16 rounding of mxtpu's
    np.testing.assert_allclose(tgot, jgot, rtol=2 ** -7, atol=1e-2)
    full = x @ np.random.RandomState(8).uniform(-1, 1, (5, 8)).T
    assert np.abs(tgot - full).max() > 1e-5  # the bf16 cast did happen


def test_quantization_rides_the_framework():
    for mx in (jmx, tmx):
        from importlib import import_module

        q = import_module(mx.__name__ + ".contrib.quantization")
        out = mx.sym.Activation(mx.sym.FullyConnected(
            mx.sym.Variable("data"), num_hidden=8, name="fcQ"),
            act_type="relu")
        qsym, offline = q.quantize_symbol(out, None)
        ops = [op for _, op in graph_of(qsym)]
        assert {"_contrib_quantize_v2", "_contrib_quantized_fully_connected",
                "_contrib_dequantize"} <= set(ops)
        assert "fcQ_weight" in offline and "fcQ_bias" in offline


def test_wrapped_random_node_draws_like_mxtpu():
    """A Dropout inside a wrapped region draws from the port's generator
    (the JAX package folds a key a random node): held by distribution,
    the kept share within 4 standard errors of 1 - p and the kept values
    1 / (1 - p), in both packages."""
    p, shape = 0.3, (200, 100)
    for mx, sg in PACKAGES:
        class S(sg.SubgraphSelector):
            def select(self, node):
                return node.op.name == "Dropout"

        class WrapDropout(sg.SubgraphProperty):
            def create_selector(self):
                return S()

        out = mx.sym.Dropout(mx.sym.Variable("data"), p=p, name="dropR")
        psym = sg.partition_with_property(out, WrapDropout())
        assert [op for _, op in graph_of(psym)] == [None, "_subgraph_exec"]
        exe = psym.simple_bind(ctx=mx.cpu(), grad_req="null", data=shape)
        kept = [exe.forward(is_train=True, data=nd(mx, np.ones(
            shape, np.float32)))[0].asnumpy() for _ in range(2)]
        for k in kept:
            assert set(np.unique(k)) <= {0.0, np.float32(1 / (1 - p))}
            assert abs((k != 0).mean() - (1 - p)) < 4 * np.sqrt(
                p * (1 - p) / k.size)
        assert not np.array_equal(kept[0], kept[1])  # fresh draws
