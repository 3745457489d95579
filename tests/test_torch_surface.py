"""The PyTorch port's NDArray and Symbol methods, the `nd` functions,
DLPack, `autograd.grad` and `autograd.Function`, and the root names,
each held against the JAX package (`mxtpu`) on the same inputs on the
CPU.

Values must agree within 1e-5 relative (plus 1e-6 of the output's
largest magnitude: `test_torch_ops.close`), integer and ordering
results exactly.  Where the port deliberately differs (`optimize`,
which waits for ROADMAP A17), the test says so.
"""
import numpy as np
import pytest
import torch

import mxtpu as jmx
import mxtpu_torch as tmx
from mxtpu_torch.base import MXNetError
from test_torch_ops import close

torch.set_num_threads(1)

X = np.random.RandomState(0).uniform(-2, 2, (3, 4)).astype(np.float32)
X[1, 2] = X[1, 0]  # a tie in row 1
IDX = np.array([2, 0, 3], np.float32)


def _arr(M, x=X):
    return M.nd.array(x, ctx=M.cpu())


def _out(r):
    if isinstance(r, (list, tuple)):
        return [x.asnumpy() for x in r]
    return r.asnumpy() if hasattr(r, "asnumpy") else r


METHODS = {
    "T": lambda M, a: a.T,
    "abs": lambda M, a: a.abs(),
    "argmin": lambda M, a: a.argmin(axis=1),
    "argsort": lambda M, a: a.argsort(is_ascend=False),
    "broadcast_like": lambda M, a: a[0:1].broadcast_like(a),
    "broadcast_to": lambda M, a: a[0:1].broadcast_to((3, 4)),
    "clip": lambda M, a: a.clip(-1.0, 1.0),
    "dot": lambda M, a: a.dot(a.T),
    "exp": lambda M, a: a.exp(),
    "expand_dims": lambda M, a: a.expand_dims(1),
    "flip": lambda M, a: a.flip(1),
    "item": lambda M, a: a[1, 2].item(),
    "log": lambda M, a: a.abs().log(),
    "log_softmax": lambda M, a: a.log_softmax(axis=0),
    "max": lambda M, a: a.max(axis=1, keepdims=True),
    "min": lambda M, a: a.min(),
    "norm": lambda M, a: a.norm(),
    "norm_axis": lambda M, a: a.norm(ord=1, axis=1),
    "one_hot": lambda M, a: _arr(M, IDX).one_hot(4),
    "ones_like": lambda M, a: a.ones_like(),
    "pick": lambda M, a: a.pick(_arr(M, IDX), axis=1),
    "prod": lambda M, a: a.prod(axis=0),
    "relu": lambda M, a: a.relu(),
    "reshape_like": lambda M, a: a.reshape_like(_arr(M, np.zeros((2, 6)))),
    "sigmoid": lambda M, a: a.sigmoid(),
    "sign": lambda M, a: a.sign(),
    "slice": lambda M, a: a.slice((1, 0), (3, 4), (1, 2)),
    "slice_axis": lambda M, a: a.slice_axis(1, 1, None),
    "softmax": lambda M, a: a.softmax(),
    "sort": lambda M, a: a.sort(axis=0, is_ascend=False),
    "sqrt": lambda M, a: a.abs().sqrt(),
    "square": lambda M, a: a.square(),
    "squeeze": lambda M, a: a.expand_dims(0).squeeze(),
    "swapaxes": lambda M, a: a.swapaxes(0, 1),
    "take": lambda M, a: a.take(_arr(M, IDX), axis=1, mode="wrap"),
    "tanh": lambda M, a: a.tanh(),
    "topk": lambda M, a: a.topk(k=2, ret_typ="both"),
    "zeros_like": lambda M, a: a.zeros_like(),
    "int": lambda M, a: int(_arr(M, np.float32([3.7]))),
    "iter": lambda M, a: [r for r in a],
    "abs_op": lambda M, a: abs(a),
    "matmul": lambda M, a: a @ a.T,
    "mod": lambda M, a: a % 0.75,
    "mod_array": lambda M, a: a % _arr(M, np.full((3, 4), -0.7, np.float32)),
    "rmod": lambda M, a: 2.5 % (a.abs() + 0.5),
    "pow_array": lambda M, a: a.abs() ** _arr(M, X[::-1].copy()),
    "rpow": lambda M, a: 1.5 ** a,
    "eq": lambda M, a: a == a[1:2],
    "ne": lambda M, a: a != 0.5,
    "ge": lambda M, a: a >= a.T.T,
    "lt": lambda M, a: a < _arr(M, X[:, :1].copy()),
    "le": lambda M, a: a <= 0,
    "gt_broadcast": lambda M, a: a > _arr(M, X[:1].copy()),
}


@pytest.mark.parametrize("name", sorted(METHODS))
def test_ndarray_methods_match_mxtpu(name):
    j = _out(METHODS[name](jmx, _arr(jmx)))
    t = _out(METHODS[name](tmx, _arr(tmx)))
    if not isinstance(j, list):
        j, t = [j], [t]
    assert len(t) == len(j)
    for a, b in zip(t, j):
        close(a, b, name)


def test_ndarray_has_every_method_of_mxtpu_that_the_slice_ports():
    wanted = {"T", "abs", "argmin", "argsort", "broadcast_like",
              "broadcast_to", "clip", "dlpack", "dot", "exp", "expand_dims",
              "flip", "item", "log", "log_softmax", "max", "min", "norm",
              "one_hot", "ones_like", "pick", "prod", "relu",
              "reshape_like", "sigmoid", "sign", "slice", "slice_axis",
              "softmax", "sort", "sqrt", "square", "squeeze", "swapaxes",
              "take", "tanh", "to_dlpack_for_read", "to_dlpack_for_write",
              "topk", "zeros_like"}
    assert len(wanted) == 40
    assert wanted <= set(dir(jmx.nd.NDArray))
    assert not wanted - set(dir(tmx.nd.NDArray))


def test_methods_record_gradients():
    grads = []
    for M in (jmx, tmx):
        a = _arr(M)
        a.attach_grad()
        with M.autograd.record():
            y = (a.clip(-1, 1) * a.max(axis=1, keepdims=True)).sum() + \
                a.sigmoid().norm()
        y.backward()
        grads.append(a.grad.asnumpy())
    close(grads[1], grads[0], "gradient")


FUNCTIONS = {
    "from_numpy": lambda M: M.nd.from_numpy(X, ctx=M.cpu()),
    "empty": lambda M: M.nd.empty((2, 3), ctx=M.cpu()),
    "arange": lambda M: M.nd.arange(1, 7, 1.5, repeat=2, ctx=M.cpu()),
    "arange_stop": lambda M: M.nd.arange(5, ctx=M.cpu(), dtype="int32"),
    "eye": lambda M: M.nd.eye(3, 4, k=1, ctx=M.cpu()),
    "maximum": lambda M: M.nd.maximum(_arr(M), _arr(M, X[:1].copy())),
    "maximum_scalar": lambda M: M.nd.maximum(0.5, _arr(M)),
    "minimum": lambda M: M.nd.minimum(_arr(M), -0.25),
    "minimum_host": lambda M: M.nd.minimum(3, 4),
    "concat": lambda M: M.nd.concat(_arr(M), _arr(M), dim=0),
    "stack": lambda M: M.nd.stack(_arr(M), _arr(M), axis=2),
    "split": lambda M: M.nd.split(_arr(M), num_outputs=2, axis=1),
    "moveaxis": lambda M: M.nd.moveaxis(_arr(M), source=0, destination=1),
    "scalar_array": lambda M: M.nd.array(np.float32(2.5), ctx=M.cpu()),
}


@pytest.mark.parametrize("name", sorted(FUNCTIONS))
def test_nd_functions_match_mxtpu(name):
    j, t = _out(FUNCTIONS[name](jmx)), _out(FUNCTIONS[name](tmx))
    if not isinstance(j, list):
        j, t = [j], [t]
    for a, b in zip(t, j):
        close(a, b, name, exact=True)


def test_concat_and_stack_take_a_list():
    """MXNet's ``nd.concat([a, b])`` and ``nd.stack([a, b])``, held to
    the positional form in ``mxtpu`` (whose generated wrappers read a
    list as one array)."""
    a, b = _arr(tmx), _arr(tmx, X + 1)
    ja, jb = _arr(jmx), _arr(jmx, X + 1)
    close(tmx.nd.concat([a, b], dim=0).asnumpy(),
          jmx.nd.concat(ja, jb, dim=0).asnumpy(), "concat", exact=True)
    close(tmx.nd.stack((a, b), axis=2).asnumpy(),
          jmx.nd.stack(ja, jb, axis=2).asnumpy(), "stack", exact=True)


def test_dlpack_round_trips():
    a = _arr(tmx)
    back = torch.utils.dlpack.from_dlpack(a.to_dlpack_for_read())
    np.testing.assert_array_equal(back.numpy(), X)
    ref = jmx.nd.array(X, ctx=jmx.cpu())
    np.testing.assert_array_equal(np.from_dlpack(ref), back.numpy())
    np.testing.assert_array_equal(torch.utils.dlpack.from_dlpack(
        tmx.nd.to_dlpack_for_read(a)).numpy(), X)
    # from a torch tensor and from numpy, sharing memory with the producer
    src = torch.arange(6, dtype=torch.float32)
    b = tmx.nd.from_dlpack(src)
    src[0] = 7.0
    assert b.asnumpy()[0] == 7.0
    np.testing.assert_array_equal(tmx.nd.from_dlpack(X).asnumpy(), X)
    np.testing.assert_array_equal(np.from_dlpack(a), X)
    # the port through the reference's consumer and back
    j = jmx.nd.from_dlpack(a)
    np.testing.assert_array_equal(j.asnumpy(), X)
    np.testing.assert_array_equal(
        tmx.nd.from_dlpack(ref.to_dlpack_for_read()).asnumpy(), X)


def test_dlpack_write_form_writes_into_the_array():
    """The write form raises in both packages, naming the supported way
    to write into an array from another framework: export for reading,
    write in the consumer, import with `from_dlpack` and assign."""
    for mx in (jmx, tmx):
        a = mx.nd.array(X, ctx=mx.cpu())
        for export in (a.to_dlpack_for_write,
                       lambda: mx.nd.to_dlpack_for_write(a)):
            with pytest.raises(mx.base.MXNetError,
                               match="to_dlpack_for_read.*from_dlpack"):
                export()
    a = _arr(tmx)
    t = torch.utils.dlpack.from_dlpack(a.to_dlpack_for_read()).clone()
    t.mul_(2)
    a[:] = tmx.nd.from_dlpack(t)
    np.testing.assert_array_equal(a.asnumpy(), 2 * X)


# ---------------------------------------------------------------------------
# Symbol
# ---------------------------------------------------------------------------

def _graph(M):
    with M.sym.NameManager():
        with M.AttrScope(ctx_group="stage1"):
            data = M.sym.Variable("data", shape=(2, 3), dtype="float16")
            fc = M.sym.FullyConnected(data=data, num_hidden=4, name="fc")
        out = M.sym.relu(fc, name="act")
    return data, fc, out


def test_symbol_attrs_children_and_types_match_mxtpu():
    res = []
    for M in (jmx, tmx):
        data, fc, out = _graph(M)
        kids = out.get_children()
        res.append(dict(
            attr=(fc.attr("ctx_group"), fc.attr("num_hidden"),
                  out.attr("ctx_group"), data.attr("__dtype__")),
            list_attr=fc.list_attr(),
            attr_dict=out.attr_dict(),
            children=kids.list_outputs(),
            leaf=data.get_children(),
            types=out.infer_type(),
            types_given=out.infer_type(fc_weight="float16"),
            types_plain=M.sym.relu(M.sym.Variable("x")).infer_type(
                x="float16")))
    j, t = res
    for k in j:
        assert str(t[k]) == str(j[k]), (k, t[k], j[k])


def test_symbol_method_forms_and_eval_match_mxtpu():
    x = np.random.RandomState(1).uniform(-1, 2, (2, 3, 4)).astype(np.float32)
    forms = {
        "reshape": lambda s: s.reshape((6, 4)),
        "transpose": lambda s: s.transpose((2, 0, 1)),
        "flatten": lambda s: s.flatten(),
        "sum": lambda s: s.sum(axis=1),
        "mean": lambda s: s.mean(axis=(0, 2), keepdims=True),
        "softmax": lambda s: s.softmax(axis=1),
        "astype": lambda s: s.astype("float16"),
        "expand_dims": lambda s: s.expand_dims(1),
        "squeeze": lambda s: s.expand_dims(0).squeeze(axis=0),
        "slice_axis": lambda s: s.slice_axis(2, 1, 3),
        "pow": lambda s: s ** 2,
        "pow_sym": lambda s: s ** s,
        "eq": lambda s: s == 0.5,
        "ne": lambda s: s != s,
        "ge": lambda s: s >= 1.0,
        "lt": lambda s: s < s * 2,
        "le": lambda s: s <= 0,
    }
    for name, form in forms.items():
        outs = []
        for M in (jmx, tmx):
            with M.sym.NameManager():
                s = form(M.sym.Variable("x"))
            out = s.eval(ctx=M.cpu(), x=M.nd.array(x, ctx=M.cpu()))
            outs.append((s.list_arguments(), s.list_outputs(),
                         out[0].asnumpy()))
        (ja, jo, jv), (ta, to, tv) = outs
        assert (ta, to) == (ja, jo), name
        close(tv, jv, name)


def test_symbol_has_its_methods_and_the_passes_raise_naming_a17():
    for m in ("infer_type", "attr", "list_attr", "get_children", "eval",
              "optimize", "optimize_for", "reshape", "transpose", "flatten",
              "sum", "mean", "softmax", "astype", "expand_dims", "squeeze",
              "slice_axis"):
        assert hasattr(tmx.sym.Symbol, m), m
    s = tmx.sym.relu(tmx.sym.Variable("x"))
    with pytest.raises(MXNetError, match="A17"):
        s.optimize()
    # optimize_for is ported: "TPU" rewrites parameters, so without them
    # it raises in both packages
    for M in (jmx, tmx):
        with pytest.raises(M.MXNetError, match="arg_params"):
            M.sym.relu(M.sym.Variable("x")).optimize_for("TPU")


def test_name_prefix_matches_mxtpu():
    names = []
    for M in (jmx, tmx):
        with M.name.Prefix("enc_"):
            names.append(M.sym.FullyConnected(M.sym.Variable("d"),
                                              num_hidden=2).list_arguments())
    assert names[0] == names[1]


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

def _grad_run(M, create_graph, head=None):
    x = _arr(M)
    x.attach_grad()
    w = _arr(M, X[::-1].copy())
    with M.autograd.record():
        y = (x * x * w).sum(axis=1) + M.nd.sin(x).sum(axis=1)
        hg = None if head is None else _arr(M, head)
        g, = M.autograd.grad(y, [x], head_grads=hg,
                             create_graph=create_graph)
        z = (g * g).sum() if create_graph else None
    if create_graph:
        z.backward()
        return g.asnumpy(), x.grad.asnumpy()
    return g.asnumpy(), x.grad.asnumpy()


@pytest.mark.parametrize("create_graph", [False, True])
@pytest.mark.parametrize("head", [None, np.float32([1.0, -2.0, 0.5])])
def test_autograd_grad_matches_mxtpu(create_graph, head):
    (jg, jx), (tg, tx) = (_grad_run(M, create_graph, head)
                          for M in (jmx, tmx))
    close(tg, jg, "grad")
    close(tx, jx, "x.grad after grad")
    if not create_graph:
        assert not tx.any()  # grad leaves .grad untouched


def test_autograd_grad_of_an_intermediate_and_an_unused_variable():
    res = []
    for M in (jmx, tmx):
        x, u = _arr(M), _arr(M, X + 1)
        x.attach_grad()
        u.attach_grad()
        with M.autograd.record():
            h = x.exp()
            y = (h * h).sum()
        res.append([g.asnumpy() for g in M.autograd.grad(y, [h, x, u])])
    for t, j in zip(*res[::-1]):
        close(t, j, "grad")


def test_autograd_grad_needs_a_recorded_or_marked_variable():
    x = _arr(tmx)
    with pytest.raises(MXNetError, match="not used in the graph"):
        tmx.autograd.grad(x * 2, [x])


def _function_run(M):
    class ScaledSigmoid(M.autograd.Function):
        def forward(self, x, s):
            y = 1 / (1 + (-x).exp())
            self.save_for_backward(y, s)
            return y * s, y

        def backward(self, dy, dz):
            y, s = self.saved_tensors
            d = y * (1 - y)
            return (dy * s + dz) * d, dy * y

    x, s = _arr(M), _arr(M, X[:1].copy() + 3)
    x.attach_grad()
    s.attach_grad()
    with M.autograd.record():
        a, b = ScaledSigmoid()(x, s.broadcast_to((3, 4)))
        loss = (a * 2 + b).sum()
    loss.backward()
    plain = ScaledSigmoid()(_arr(M), _arr(M))[0].asnumpy()
    return a.asnumpy(), x.grad.asnumpy(), s.grad.asnumpy(), plain


def test_autograd_function_matches_mxtpu():
    for t, j in zip(_function_run(tmx), _function_run(jmx)):
        close(t, j, "Function")


def test_root_names():
    for n in ("seed", "NDArray", "Symbol", "Executor", "CachedOp",
              "AttrScope", "name"):
        assert hasattr(tmx, n), n
    assert tmx.NDArray is tmx.nd.NDArray and tmx.Symbol is tmx.sym.Symbol
    tmx.seed(4)
    a = tmx.random.uniform(shape=(3,), ctx=tmx.cpu()).asnumpy()
    tmx.random.seed(4, ctx=tmx.cpu())
    b = tmx.random.uniform(shape=(3,), ctx=tmx.cpu()).asnumpy()
    np.testing.assert_array_equal(a, b)
