"""The PyTorch port's `Custom` op and `mx.operator`
(`mxtpu_torch/ops/custom_op.py`, `mxtpu_torch/operator.py`) against the
JAX package's, case by case as `tests/test_custom_op.py` holds `mxtpu`,
and beyond: the forward and backward imperatively, inside a bound
Symbol (its shapes and dtypes from the prop's `infer_shape` and
`infer_type`), a two-output op's order, a loss head with
`need_top_grad=False` trained through `Module`, a hybridized block, and
`FusedTrainLoop` over a graph holding a `Custom` node: never captured
(`capturable` is False, also for a `Custom` inside a `_subgraph_exec`),
its K steps equal to K per-step steps.

Both packages run the same user code on the same numpy inputs; values
agree within `test_torch_ops`'s bound (1e-5 relative plus 1e-6 of the
largest magnitude) and the closed forms within 1e-6 relative.
"""
import numpy as np
import pytest
import torch

import mxtpu as jmx
import mxtpu_torch as tmx
from test_torch_ops import close

torch.set_num_threads(1)

PACKAGES = (jmx, tmx)


def register_ops(mx):
    """tt_sq2 (x^2), tt_split2 (2x, 3x) and a softmax loss head in
    ``mx``'s registry (names that `tests/test_custom_op.py`, which may
    run in the same process, does not register)."""

    class Square2(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0] * in_data[0])

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], 2 * in_data[0] * out_grad[0])

    @mx.operator.register("tt_sq2")
    class Square2Prop(mx.operator.CustomOpProp):
        def list_arguments(self):
            return ["data"]

        def list_outputs(self):
            return ["output"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return Square2()

    class Split2(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0] * 2)
            self.assign(out_data[1], req[1], in_data[0] * 3)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0],
                        out_grad[0] * 2 + out_grad[1] * 3)

    @mx.operator.register("tt_split2")
    class Split2Prop(mx.operator.CustomOpProp):
        def list_outputs(self):
            return ["a", "b"]

        def create_operator(self, ctx, shapes, dtypes):
            return Split2()

    class SoftmaxLoss(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            e = np.exp(x - x.max(axis=1, keepdims=True))
            self.assign(out_data[0], req[0],
                        mx.nd.array(e / e.sum(axis=1, keepdims=True)))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            p = out_data[0].asnumpy().copy()
            label = in_data[1].asnumpy().astype(np.int64)
            p[np.arange(len(label)), label] -= 1.0
            self.assign(in_grad[0], req[0], mx.nd.array(p / len(label)))
            self.assign(in_grad[1], req[1], mx.nd.zeros(label.shape))

    @mx.operator.register("tt_softmax_loss")
    class SoftmaxLossProp(mx.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def infer_shape(self, in_shape):
            return [in_shape[0], (in_shape[0][0],)], [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return SoftmaxLoss()


for _mx in PACKAGES:
    register_ops(_mx)


def nd(mx, x):
    return mx.nd.array(x, ctx=mx.cpu())


@pytest.fixture(autouse=True)
def port_on_the_cpu(monkeypatch):
    """The user's ops make arrays without a context, which the port
    places on the card: here the CPU is the default, as for a user
    without one."""
    monkeypatch.setattr(tmx.context, "default_ctx",
                        lambda: torch.device("cpu"))


def test_forward_and_backward():
    x = np.array([[1.0, 2.0, -0.5], [3.0, -4.0, 0.25]], np.float32)
    res = []
    for mx in PACKAGES:
        a = nd(mx, x)
        a.attach_grad()
        with mx.autograd.record():
            y = mx.nd.Custom(a, op_type="tt_sq2")
            loss = (y * y).sum()
        loss.backward()
        res.append((y.asnumpy(), a.grad.asnumpy()))
    for t, j in zip(res[1], res[0]):
        close(t, j, "tt_sq2")
    np.testing.assert_allclose(res[1][0], x ** 2, rtol=1e-6)
    np.testing.assert_allclose(res[1][1], 4 * x ** 3, rtol=1e-6)


def test_multi_output_order_and_gradient():
    x = np.random.RandomState(0).uniform(-1, 1, (2, 3)).astype(np.float32)
    for mx in PACKAGES:
        a = nd(mx, x)
        a.attach_grad()
        with mx.autograd.record():
            p, q = mx.nd.Custom(a, op_type="tt_split2")
            loss = (p + q * q).sum()
        loss.backward()
        np.testing.assert_allclose(p.asnumpy(), 2 * x, rtol=1e-6)
        np.testing.assert_allclose(q.asnumpy(), 3 * x, rtol=1e-6)
        np.testing.assert_allclose(a.grad.asnumpy(), 2 + 3 * 2 * 3 * x,
                                   rtol=1e-5)


def test_in_a_bound_symbol():
    x = np.array([[1.0, 2.0], [3.0, 4.0]], np.float32)
    for mx in PACKAGES:
        out = mx.sym.Custom(mx.sym.Variable("data"), op_type="tt_sq2",
                            name="sq")
        assert out.list_outputs() == ["sq_output"]
        _, shapes, _ = out.infer_shape(data=(2, 2))
        assert [tuple(s) for s in shapes] == [(2, 2)]
        _, types, _ = out.infer_type(data=np.float32)
        assert [np.dtype(t) for t in types] == [np.float32]
        ex = out.simple_bind(ctx=mx.cpu(), grad_req={"data": "write"},
                             data=(2, 2))
        (y,) = ex.forward(is_train=True, data=nd(mx, x))
        ex.backward(nd(mx, np.ones((2, 2), np.float32)))
        np.testing.assert_allclose(y.asnumpy(), x ** 2)
        np.testing.assert_allclose(ex.grad_dict["data"].asnumpy(), 2 * x)
        two = mx.sym.Custom(mx.sym.Variable("data"), op_type="tt_split2",
                            name="sp")
        assert two.list_outputs() == ["sp_output0", "sp_output1"]


def loss_net(mx):
    s = mx.sym
    h = s.FullyConnected(s.Variable("data"), num_hidden=8, name="fc1")
    h = s.FullyConnected(s.Activation(h, act_type="relu"), num_hidden=4,
                         name="fc2")
    return s.Custom(h, s.Variable("softmax_label"), op_type="tt_softmax_loss",
                    name="softmax")


def module_run(mx, steps, fused=False):
    """``steps`` SGD steps of ``loss_net`` through Module (or one
    FusedTrainLoop call) from weights drawn with numpy."""
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (steps, 6, 5)).astype(np.float32)
    y = rng.randint(0, 4, (steps, 6)).astype(np.float32)
    mod = mx.mod.Module(loss_net(mx), context=mx.cpu(),
                        label_names=("softmax_label",))
    mod.bind(data_shapes=[("data", (6, 5))],
             label_shapes=[("softmax_label", (6,))])
    init = {"fc1_weight": rng.uniform(-0.5, 0.5, (8, 5)),
            "fc1_bias": np.zeros(8), "fc2_weight":
            rng.uniform(-0.5, 0.5, (4, 8)), "fc2_bias": np.zeros(4)}
    mod.init_params(arg_params={k: nd(mx, v.astype(np.float32))
                                for k, v in init.items()})
    mod.init_optimizer(optimizer="sgd", kvstore=None,
                       optimizer_params={"learning_rate": 0.5})
    batches = [mx.io.DataBatch([nd(mx, x[k])], [nd(mx, y[k])])
               for k in range(steps)]
    loop = None
    if fused:
        loop = mx.FusedTrainLoop(mod, steps_per_program=steps)
        outs = loop.run(batches)[0].asnumpy()
    else:
        outs = []
        for b in batches:
            mod.forward(b, is_train=True)
            mod.backward()
            mod.update()
            outs.append(mod.get_outputs()[0].asnumpy())
        outs = np.stack(outs)
    args, _ = mod.get_params()
    return outs, {k: v.asnumpy() for k, v in args.items()}, loop


def test_loss_head_trains_through_module_like_mxtpu():
    (jo, ja, _), (to, ta, _) = [module_run(mx, 4) for mx in PACKAGES]
    close(to, jo, "outputs")
    for k in ja:
        close(ta[k], ja[k], k)
    assert not np.allclose(ta["fc1_weight"], module_run(tmx, 1)[1][
        "fc1_weight"])


def test_fused_loop_runs_a_custom_graph_step_by_step():
    outs, args, loop = module_run(tmx, 4, fused=True)
    assert loop.capturable is False
    ref_outs, ref_args, _ = module_run(tmx, 4)
    np.testing.assert_allclose(outs, ref_outs, rtol=1e-6, atol=1e-7)
    for k in ref_args:
        np.testing.assert_allclose(args[k], ref_args[k], rtol=1e-6,
                                   atol=1e-7)
    # a Custom inside a packed subgraph is found too
    from mxtpu_torch.fused_train import _runs_host_ops
    from mxtpu_torch.subgraph import SubgraphProperty, SubgraphSelector, \
        partition_with_property

    class Sel(SubgraphSelector):
        def select(self, node):
            return node.op.name == "Custom"

    class Wrap(SubgraphProperty):
        def create_selector(self):
            return Sel()

    net = loss_net(tmx)
    packed = partition_with_property(net, Wrap())
    assert "Custom" not in [n.op.name for n in packed._topo()
                            if not n.is_variable]
    assert _runs_host_ops(packed) and _runs_host_ops(net)
    assert not _runs_host_ops(tmx.sym.relu(tmx.sym.Variable("x")))


def test_in_a_hybridized_block():
    x = np.random.RandomState(1).uniform(-1, 1, (3, 4)).astype(np.float32)
    for mx in PACKAGES:
        class Block(mx.gluon.HybridBlock):
            def hybrid_forward(self, F, data):
                return F.Custom(data, op_type="tt_sq2") + 1

        net = Block()
        net.hybridize()
        a = nd(mx, x)
        a.attach_grad()
        with mx.autograd.record():
            y = net(a)
        y.backward()
        np.testing.assert_allclose(y.asnumpy(), x ** 2 + 1, rtol=1e-6)
        np.testing.assert_allclose(a.grad.asnumpy(), 2 * x, rtol=1e-6)


def test_unregistered_op_type_raises():
    for mx in PACKAGES:
        with pytest.raises(mx.MXNetError):
            mx.nd.Custom(nd(mx, np.ones(2, np.float32)), op_type="nope")
        with pytest.raises(mx.MXNetError):
            mx.operator.register("bad")(object)
