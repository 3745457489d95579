"""The cases of the PyTorch port's op sweep: for every canonical op the
port registers, the calls to make (numpy inputs from fixed seeds, the
attrs, the inputs whose gradients count, whether the outputs must be
equal), with the ties and bounds where torch's defaults differ from the
reference's; and how a call is run (`run_call`) and judged
(`error_units`).  `tests/test_torch_ops.py` runs them against the JAX
package on the CPU; `chip_smoke.py`'s ops phase runs them on the card
against the CPU.  This file imports neither JAX nor the JAX package,
and holds no test of its own.
"""
import numpy as np


def grad_inputs(opdef, c):
    """The inputs of the call ``c`` whose gradients count: those it
    names, else every float input of a differentiable op."""
    if c.grad is not None:
        return tuple(c.grad)
    if not opdef.differentiable:
        return ()
    return tuple(i for i, x in enumerate(c.inputs)
                 if np.issubdtype(x.dtype, np.floating))


def run_call(mx, name, c, ctx, grad_idx):
    """(outputs, gradients of the inputs ``grad_idx``) of ``mx.nd.<name>``
    on ``ctx``, as numpy; the gradients are of the outputs' sum weighted
    by normal draws from seeds 7, 8..."""
    xs = [mx.nd.array(x, ctx=ctx, dtype=x.dtype) for x in c.inputs]
    attrs = dict(c.attrs)
    if c.build is not None:
        attrs.update(c.build(mx))
    if not xs:
        attrs["ctx"] = ctx
    fn = getattr(mx.nd, name)
    canon = c.canon or (lambda outs: outs)
    if not grad_idx:
        out = fn(*xs, **attrs)
        outs = out if isinstance(out, list) else [out]
        return canon([o.asnumpy() for o in outs]), []
    for i in grad_idx:
        xs[i].attach_grad()
    with mx.autograd.record():
        out = fn(*xs, **attrs)
    outs = out if isinstance(out, list) else [out]
    heads = [mx.nd.array(np.random.RandomState(7 + k).normal(
        0, 1, o.shape).astype(np.float32), ctx=ctx)
        for k, o in enumerate(outs)]
    mx.autograd.backward(outs, heads)
    return canon([o.asnumpy() for o in outs]), [xs[i].grad.asnumpy()
                                                for i in grad_idx]


def error_units(got, want, exact, rtol, atol):
    """The error of ``got`` against ``want`` in units of the bound (at
    most 1 passes): |got - want| over rtol |want| plus atol times the
    output's largest magnitude; for integer results and ``exact``, 0 when
    equal, else inf."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        return float("inf")
    if exact or not np.issubdtype(want.dtype, np.floating):
        return 0.0 if np.array_equal(got, want) else float("inf")
    if not np.issubdtype(got.dtype, np.floating):
        return float("inf")
    g, w = got.astype(np.float64), want.astype(np.float64)
    if not np.array_equal(np.isnan(g), np.isnan(w)):
        return float("inf")
    ok = ~np.isnan(w)
    if not ok.any():
        return 0.0
    scale = max(1.0, float(np.abs(w[ok]).max()))
    return float((np.abs(g - w)[ok] /
                  (rtol * np.abs(w[ok]) + atol * scale)).max())


def _a(*shape, lo=-1.0, hi=1.0, seed=0, dtype=np.float32):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(dtype)


def _away(*shape, lo=0.2, hi=2.0, seed=0):
    """Values of both signs with magnitudes in [lo, hi]."""
    rng = np.random.RandomState(seed)
    mag = rng.uniform(lo, hi, shape)
    return (mag * rng.choice([-1.0, 1.0], shape)).astype(np.float32)


def _f(values):
    return np.asarray(values, np.float32)


class Call(object):
    """One call of an op: its inputs (numpy), its attrs, the inputs whose
    gradients are compared (None: every float input of a differentiable
    op), whether the outputs must be equal, ``canon``, a function
    of the outputs (numpy) that takes out what the libraries may choose
    apart (the signs of factors), and ``build``, a function of the
    package that gives the attrs made by that package (the subgraph
    Symbols of the control-flow ops)."""

    def __init__(self, *inputs, grad=None, exact=False, canon=None,
                 build=None, **attrs):
        self.inputs, self.attrs = inputs, attrs
        self.grad, self.exact, self.canon = grad, exact, canon
        self.build = build


CASES = {}


def case(name, *calls):
    assert name not in CASES, name
    CASES[name] = calls


# ---------------------------------------------------------------------------
# elementwise: unary
# ---------------------------------------------------------------------------

HALVES = _f([[-2.5, -1.5, -0.5, 0.5], [1.5, 2.5, 0.3, -0.7], [0.0, 3.5,
                                                             -3.5, 1.49]])

for _n in ("sin", "cos", "tanh", "arctan", "arcsinh", "exp", "expm1",
           "square", "negative", "sinh", "cosh", "erf", "degrees",
           "radians", "sigmoid", "softsign"):
    case(_n, Call(_a(3, 4, lo=-2, hi=2)))
for _n in ("log", "log10", "log2", "sqrt", "rsqrt"):
    case(_n, Call(_a(3, 4, lo=0.2, hi=3)))
case("log1p", Call(_a(3, 4, lo=-0.5, hi=2)))
case("tan", Call(_a(3, 4, lo=-1.2, hi=1.2)))
for _n in ("arcsin", "arccos", "arctanh"):
    case(_n, Call(_a(3, 4, lo=-0.9, hi=0.9)))
case("erfinv", Call(_a(3, 4, lo=-0.9, hi=0.9)))
case("arccosh", Call(_a(3, 4, lo=1.1, hi=3)))
for _n in ("cbrt", "rcbrt", "reciprocal"):
    case(_n, Call(_away(3, 4)))
case("abs", Call(np.concatenate([_away(2, 4), np.zeros((1, 4),
                                                        np.float32)])))
case("gamma", Call(_a(3, 4, lo=0.3, hi=4)),
     Call(_f([-0.5, -1.5, -2.3, -3.7, 0.7, 5.5])))
case("gammaln", Call(_a(3, 4, lo=0.3, hi=4)))
for _n in ("ceil", "floor", "trunc", "fix", "rint", "round", "sign"):
    case(_n, Call(HALVES, exact=True))
case("logical_not", Call(_f([[0, 1.5, -2], [0, 0, 3]]), exact=True))
case("relu", Call(_away(3, 4)))
case("hard_sigmoid", Call(_away(3, 4, lo=0.1, hi=4)),
     # at alpha 0.25 and beta 0.5, -2 and 2 land on the bounds exactly
     Call(_f([-3, -2, -1, 0, 1, 2, 3]), alpha=0.25, beta=0.5))
case("Activation", *[Call(_away(3, 4), act_type=t) for t in
                     ("relu", "sigmoid", "tanh", "softrelu", "softsign")])
case("_copy", Call(_a(3, 4)))
# values only: the reference's backward takes no float32 head for a
# float16 output, and an int32 output has no gradient
case("Cast", Call(_a(3, 4, lo=-3, hi=3), dtype="float16", grad=()),
     Call(_a(3, 4, lo=-3, hi=3), dtype="int32", grad=()))
case("zeros_like", Call(_a(3, 4), grad=()))  # the gradient is zero
case("ones_like", Call(_a(3, 4), grad=()))
case("shape_array", Call(_a(2, 3, 4)))
case("size_array", Call(_a(2, 3, 4)))
case("make_loss", Call(_a(3, 4)))
# values here; the gradient (zero) in test_torch_ops.py
case("BlockGrad", Call(_a(3, 4, seed=3), grad=()))



# ---------------------------------------------------------------------------
# elementwise: binary, broadcast, scalar
# ---------------------------------------------------------------------------

A, B = _a(3, 4, seed=1), _a(3, 4, seed=2)
TIED = B.copy()
TIED[:, ::2] = A[:, ::2]  # half the positions tie
MOD_A = _f([[-3, 3, -3.5, 4.25], [7, -7, 0.5, -0.5]])
MOD_B = _f([[2, -2, 2, -1.5], [-3, 3, -0.7, 0.7]])

case("elemwise_add", Call(A, B))
case("elemwise_sub", Call(A, B))
case("elemwise_mul", Call(A, B))
case("elemwise_div", Call(A, _away(3, 4, seed=2)))
case("_grad_add", Call(A, B))
case("_hypot", Call(A, B))
case("_power", Call(_a(3, 4, lo=0.3, hi=2), B))
case("_maximum", Call(A, TIED))
case("_minimum", Call(A, TIED))
case("_mod", Call(MOD_A, MOD_B))
for _n in ("_equal", "_not_equal", "_greater", "_greater_equal", "_lesser",
           "_lesser_equal"):
    case(_n, Call(A, TIED, exact=True))
LOGIC_A = _f([[0, 1, 0, -2], [3, 0, 0.5, 0]])
LOGIC_B = _f([[0, 0, 2, -1], [0, 1, 0.5, 0]])
for _n in ("_logical_and", "_logical_or", "_logical_xor"):
    case(_n, Call(LOGIC_A, LOGIC_B, exact=True))

BA, BB = _a(3, 1, 4, seed=4), _a(1, 5, 4, seed=5)
BB_TIED = np.broadcast_to(BA, (3, 5, 4)).copy()
BB_TIED[:, 1::2] = _a(3, 2, 4, seed=6)
for _n in ("broadcast_add", "broadcast_sub", "broadcast_mul",
           "broadcast_hypot"):
    case(_n, Call(BA, BB))
case("broadcast_div", Call(BA, _away(1, 5, 4, seed=5)))
case("broadcast_power", Call(_a(3, 1, 4, lo=0.3, hi=2), BB))
case("broadcast_maximum", Call(BA, BB_TIED))
case("broadcast_minimum", Call(BA, BB_TIED))
case("broadcast_mod", Call(_f([[-3], [3]]), _f([[2, -2]])),
     Call(MOD_A.reshape(2, 1, 4), MOD_B.reshape(1, 2, 4)))
for _n in ("broadcast_equal", "broadcast_not_equal", "broadcast_greater",
           "broadcast_greater_equal", "broadcast_lesser",
           "broadcast_lesser_equal"):
    case(_n, Call(BA, BB_TIED, exact=True))
for _n in ("broadcast_logical_and", "broadcast_logical_or",
           "broadcast_logical_xor"):
    case(_n, Call(LOGIC_A[:, None, :], LOGIC_B[None], exact=True))
case("broadcast_axis", Call(_a(3, 1, 4), axis=1, size=5),
     Call(_a(1, 1, 4), axis=(0, 1), size=(2, 3)))
case("broadcast_to", Call(_a(3, 1, 4), shape=(3, 5, 4)),
     Call(_a(1, 2, 1), shape=(4, 0, 3)))  # 0 keeps the dimension
case("broadcast_like", Call(_a(3, 1, 4), _a(3, 5, 4), grad=(0,)))

INTS = np.array([[-7, -3, 0, 4], [5, 9, -1, 2]], np.int32)
case("_plus_scalar", Call(A, scalar=0.75), Call(INTS, scalar=2.5))
case("_minus_scalar", Call(A, scalar=0.75), Call(INTS, scalar=-2.5))
case("_rminus_scalar", Call(A, scalar=0.75))
case("_mul_scalar", Call(A, scalar=-1.5), Call(INTS, scalar=2.5))
case("_div_scalar", Call(A, scalar=-1.5), Call(INTS, scalar=2.5))
case("_rdiv_scalar", Call(_away(3, 4), scalar=2.0))
case("_mod_scalar", Call(MOD_A, scalar=2.0), Call(MOD_A, scalar=-1.5),
     Call(INTS, scalar=3))
case("_rmod_scalar", Call(MOD_B, scalar=-3.0), Call(MOD_B, scalar=4.5))
case("_power_scalar", Call(_a(3, 4, lo=0.3, hi=2), scalar=2.5),
     Call(INTS, scalar=2))
case("_rpower_scalar", Call(A, scalar=1.7))
case("_hypot_scalar", Call(A, scalar=0.5))
SC = _f([[-1, -0.5, 0, 0.5], [1, 0.5, 0.25, 0.5]])
case("_maximum_scalar", Call(SC, scalar=0.5))
case("_minimum_scalar", Call(SC, scalar=0.5))
case("_scatter_plus_scalar", Call(A, scalar=0.75))
case("_scatter_minus_scalar", Call(A, scalar=0.75))
for _n in ("_equal_scalar", "_not_equal_scalar", "_greater_scalar",
           "_greater_equal_scalar", "_lesser_scalar",
           "_lesser_equal_scalar", "_logical_and_scalar",
           "_logical_or_scalar", "_logical_xor_scalar"):
    case(_n, Call(SC, scalar=0.5, exact=True), Call(SC, scalar=0.0,
                                                     exact=True))
case("smooth_l1", Call(_a(3, 4, lo=-3, hi=3), scalar=1.0),
     Call(_a(3, 4, lo=-3, hi=3), scalar=2.0))
case("add_n", Call(A, B, _a(3, 4, seed=9)))

# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------

X3 = _a(2, 3, 4, seed=11)
MAXTIE = _f([[1, 3, 3, 0], [2, 2, 2, -1], [-1, 5, 0, 5]])
WITH_ZERO = _a(3, 4, lo=0.5, hi=1.5, seed=12)
WITH_ZERO[1, 2] = 0.0
WITH_NAN = _a(3, 4, seed=13)
WITH_NAN[0, 1] = WITH_NAN[2, 3] = np.nan

case("sum", Call(X3), Call(X3, axis=(0, 2), keepdims=True),
     Call(X3, axis=1, exclude=True), Call(X3, axis=()))
case("mean", Call(X3, axis=1), Call(X3, axis=(0, 2), keepdims=True),
     # a 1-D array with its only axis excluded reduces nothing
     Call(_a(5), axis=0, exclude=True))
case("prod", Call(_a(2, 3, 4, lo=0.5, hi=1.5)), Call(WITH_ZERO, axis=1),
     Call(_a(2, 3, 4, lo=0.5, hi=1.5), axis=(0, 2), keepdims=True))
case("nansum", Call(WITH_NAN, axis=1), Call(WITH_NAN))
case("nanprod", Call(WITH_NAN, axis=1), Call(WITH_NAN))
case("max", Call(MAXTIE, axis=1), Call(MAXTIE), Call(X3, axis=(0, 2),
                                                      keepdims=True))
case("min", Call(-MAXTIE, axis=1), Call(-MAXTIE), Call(X3, axis=0,
                                                        exclude=True))
case("norm", Call(_away(3, 4)), Call(_away(3, 4), ord=1, axis=1),
     Call(_away(2, 3, 4), axis=(1, 2), keepdims=True))
case("_square_sum", Call(X3, axis=1), Call(X3, axis=(0, 2), keepdims=True))
case("argmax", Call(MAXTIE, axis=1, exact=True), Call(MAXTIE, exact=True),
     Call(X3, axis=0, keepdims=True, exact=True))
case("argmin", Call(-MAXTIE, axis=1, exact=True), Call(-MAXTIE, exact=True))
case("argmax_channel", Call(MAXTIE, exact=True))
case("pick", Call(_a(3, 4), _f([0, 3, 7]), grad=(0,)),
     Call(_a(3, 4), _f([-1, 5, 2]), mode="wrap", grad=(0,)),
     Call(_a(3, 4, 2), _f([[0, 1], [2, 3], [1, 9]]), axis=1, keepdims=True,
          grad=(0,)))

# ---------------------------------------------------------------------------
# shapes, slices, products
# ---------------------------------------------------------------------------

case("Reshape", Call(X3, shape=(0, -1)), Call(X3, shape=(-3, 0)),
     Call(X3, shape=(-4, 1, 2, -2)), Call(X3, shape=(4, -1), reverse=True))
case("reshape_like", Call(X3, _a(4, 6), grad=(0,)))
case("Flatten", Call(X3))
case("transpose", Call(X3), Call(X3, axes=(1, 0, 2)))
case("where", Call(_f([[1, 0, 2, 0], [0, 0, 1, 1], [1, 1, 0, 0]]), A, B,
                   grad=(1, 2)))
case("SwapAxis", Call(X3, dim1=0, dim2=2))
case("stack", Call(A, B, axis=1))
case("Concat", Call(X3, _a(2, 1, 4), dim=1))
case("_rnn_param_concat", Call(A, _a(5)))
case("SliceChannel", Call(_a(2, 4, 3), num_outputs=2),
     Call(_a(2, 4, 3), num_outputs=4, axis=1, squeeze_axis=True))
case("one_hot", Call(_f([0, 2, 5, -1, 3]), depth=4),
     Call(_f([[1, 0], [3, 2]]), depth=4, on_value=2.0, off_value=-1.0))
case("dot", Call(_a(3, 4), _a(4, 5, seed=1)),
     Call(_a(4, 3), _a(5, 4, seed=1), transpose_a=True, transpose_b=True),
     Call(_a(2, 3, 4), _a(4, 5, seed=1)), Call(_a(4), _a(4, seed=1)))
case("batch_dot", Call(_a(2, 3, 4), _a(2, 4, 5, seed=1)),
     Call(_a(2, 4, 3), _a(2, 5, 4, seed=1), transpose_a=True,
          transpose_b=True))
case("einsum", Call(_a(2, 3, 4), _a(2, 4, 5, seed=1),
                    subscripts="bij,bjk->bik"),
     Call(_a(3, 4), subscripts="ij->j"))
case("_onnx_MatMul", Call(_a(2, 3, 4), _a(4, 5, seed=1)),
     Call(_a(2, 1, 3, 4), _a(3, 4, 2, seed=1)))
case("khatri_rao", Call(_a(3, 2), _a(4, 2, seed=1)),
     Call(_a(2, 3), _a(2, 3, seed=1), _a(3, 3, seed=2)))
case("expand_dims", Call(X3, axis=1), Call(X3, axis=-1))
case("squeeze", Call(_a(2, 1, 3, 1)), Call(_a(2, 1, 3, 1), axis=1),
     Call(_a(2, 1, 3, 1), axis=(1, 3)))
case("moveaxis", Call(X3, source=0, destination=2),
     Call(X3, source=-1, destination=0))
case("reverse", Call(X3, axis=1), Call(X3, axis=(0, 2)))
case("repeat", Call(X3, repeats=2, axis=1), Call(A, repeats=3))
case("tile", Call(X3, reps=(2, 1, 3)), Call(X3, reps=(2,)),
     Call(A, reps=(2, 1, 2)))
case("depth_to_space", Call(_a(2, 8, 3, 2), block_size=2))
case("space_to_depth", Call(_a(2, 2, 6, 4), block_size=2))
case("diag", Call(_a(4)), Call(_a(4), k=-1), Call(_a(3, 4), k=1),
     Call(_a(2, 3, 4), axis1=1, axis2=2))
case("slice", Call(X3, begin=(0, 1), end=(2, 3)),
     Call(X3, begin=(None, 0, 1), end=(None, 3, 4), step=(1, 2, 2)),
     Call(X3, begin=(1, 2), end=(None, 0), step=(-1, -1)),
     Call(X3, begin=(None, None, 3), end=(None, None, None),
          step=(None, None, -2)))
case("slice_axis", Call(X3, axis=2, begin=1, end=3),
     Call(X3, axis=-2, begin=-2, end=None))
case("slice_like", Call(X3, _a(1, 2, 3), grad=(0,)),
     Call(X3, _a(2, 2, 2), axes=(1, 2), grad=(0,)))
case("_slice_assign", Call(X3, _a(2, 2, 2, seed=3), begin=(0, 1, 1),
                           end=(2, 3, 3)),
     Call(X3, _a(2, 2, 2, seed=3), begin=(None, 2, 3),
          end=(None, 0, None), step=(1, -1, -2)))
case("_slice_assign_scalar", Call(X3, scalar=0.5, begin=(0, 1), end=(1, 3)),
     Call(X3, scalar=-2.0, begin=(None, None, 3), end=(None, None, 0),
          step=(1, 1, -2)))
CLIP = _f([[-1.0, -0.5, 0.0, 0.5], [1.0, 0.25, -0.25, 0.5]])
case("clip", Call(CLIP, a_min=-0.5, a_max=0.5),
     Call(_a(3, 4, lo=-8, hi=8), a_min=0.0, a_max=6.0))
case("Pad", Call(_a(2, 3, 4, 5), mode="constant",
                 pad_width=(0, 0, 0, 0, 1, 2, 2, 1), constant_value=0.5),
     Call(_a(2, 3, 4, 5), mode="edge", pad_width=(0, 0, 0, 0, 2, 1, 1, 3)),
     Call(_a(2, 3, 4, 5), mode="reflect",
          pad_width=(0, 0, 0, 0, 1, 2, 3, 1)))
case("Crop", Call(_a(2, 3, 6, 7), h_w=(3, 4), offset=(1, 2)),
     Call(_a(2, 3, 6, 7), h_w=(3, 4), center_crop=True),
     Call(_a(2, 3, 6, 7), _a(1, 1, 4, 5), num_args=2, grad=(0,)))

# ---------------------------------------------------------------------------
# initialization
# ---------------------------------------------------------------------------

case("_zeros", Call(shape=(2, 3)), Call(shape=(4,), dtype="int32"))
case("_ones", Call(shape=(2, 3)), Call(shape=(4,), dtype="int32"))
case("_full", Call(shape=(2, 3), value=2.5))
case("_arange", Call(start=2.0, stop=9.0, step=2.0),
     Call(start=5.0), Call(start=0.0, stop=3.0, repeat=2),
     Call(start=1.0, stop=-2.0, step=-0.5, dtype="float32"))
case("_eye", Call(N=3), Call(N=3, M=5, k=1), Call(N=4, M=3, k=-2))
case("_identity_with_attr_like_rhs", Call(A, B, grad=(0,)))

# ---------------------------------------------------------------------------
# indexing and ordering
# ---------------------------------------------------------------------------

SORTTIE = _f([[3, 1, 2, 1, 3, 0], [2, 2, 2, 5, 5, -1], [0, 4, 4, 4, 1, 1]])
case("take", Call(_a(5, 3), _f([[0, 4], [2, 9]]), grad=(0,)),
     Call(_a(3, 5), _f([-1, 6, 2]), axis=1, mode="wrap", grad=(0,)))
case("batch_take", Call(_a(3, 4), _f([0, 3, 2]), grad=(0,)))
case("gather_nd", Call(_a(3, 4, 2), _f([[0, 2, 1], [1, 3, 0]]), grad=(0,)))
# distinct indices: with repeated ones, scatter_nd sums and
# _scatter_set_nd keeps one value, which the reference leaves open
case("scatter_nd", Call(_a(3, 2), _f([[0, 2, 1], [1, 3, 0]]),
                        shape=(3, 4, 2), grad=(0,)))
case("_scatter_set_nd", Call(_a(3, 4), _a(3, seed=1),
                             _f([[0, 2, 1], [1, 3, 0]]), shape=(3, 4),
                             grad=(0, 1)))
case("sort", Call(SORTTIE), Call(SORTTIE, is_ascend=False),
     Call(SORTTIE, axis=0, is_ascend=False), Call(SORTTIE, axis=None))
case("argsort", Call(SORTTIE, exact=True),
     Call(SORTTIE, is_ascend=False, exact=True),
     Call(SORTTIE, axis=0, exact=True), Call(SORTTIE, dtype="int32",
                                             exact=True))
case("topk", *[Call(SORTTIE, k=3, ret_typ=r, is_ascend=asc, exact=True)
               for r in ("indices", "value", "both", "mask")
               for asc in (False, True)],
     Call(SORTTIE, axis=0, k=2, ret_typ="both", exact=True))
case("_ravel_multi_index", Call(_f([[0, 1, 2], [3, 0, 4]]), shape=(3, 5)))
case("_unravel_index", Call(_f([0, 7, 14, 9]), shape=(3, 5)))
case("_histogram", Call(_a(50, lo=-2, hi=2), bin_cnt=6, range=(-1.5, 1.5)))
case("_contrib_boolean_mask", Call(_a(4, 3), _f([1, 0, 1, 0]), grad=(0,)))
case("_contrib_index_copy", Call(_a(5, 3), _f([3, 0]), _a(2, 3, seed=1),
                                 grad=(0, 2)))
case("_contrib_getnnz", Call(_f([[0, 1, 0], [2, 0, 0]])),
     Call(_f([[0, 1, 0], [2, 0, 0]]), axis=0))
case("_contrib_count_sketch", Call(_a(3, 6), _f([0, 2, 1, 2, 3, 0]),
                                   _f([1, -1, 1, 1, -1, 1]), out_dim=4,
                                   grad=(0,)))
case("Embedding", Call(_f([[0, 2.7], [4, -1]]), _a(5, 3), input_dim=5,
                       output_dim=3, grad=(1,)))
case("cast_storage", Call(A, stype="default"))
case("_sparse_retain", Call(_a(4, 3), _f([0, 2]), grad=(0,)))

# ---------------------------------------------------------------------------
# nn
# ---------------------------------------------------------------------------

case("FullyConnected", Call(_a(3, 2, 2), _a(5, 4, seed=1), _a(5, seed=2),
                            num_hidden=5),
     Call(_a(3, 2, 4), _a(5, 4, seed=1), num_hidden=5, no_bias=True,
          flatten=False))
case("Convolution", Call(_a(2, 4, 6, 5), _a(6, 2, 3, 3, seed=1),
                         _a(6, seed=2), kernel=(3, 3), num_filter=6,
                         num_group=2, stride=(2, 1), pad=(1, 1)),
     Call(_a(2, 3, 7), _a(4, 3, 3, seed=1), kernel=(3,), num_filter=4,
          no_bias=True, dilate=(2,)))
case("Pooling", Call(_a(2, 3, 6, 5), kernel=(2, 2), stride=(2, 2),
                     pool_type="max"),
     Call(_a(2, 3, 6, 5), kernel=(3, 3), stride=(2, 2), pad=(1, 1),
          pool_type="avg"),
     Call(_a(2, 3, 6, 5), kernel=(1, 1), global_pool=True, pool_type="avg"))
case("BatchNorm", Call(_a(4, 3, 2, 2, lo=-2, hi=3), _a(3, lo=0.5, hi=1.5),
                       _a(3, seed=1), np.zeros(3, np.float32),
                       np.ones(3, np.float32), fix_gamma=False,
                       grad=(0, 1, 2)))
case("softmax", Call(_a(3, 4, lo=-3, hi=3)),
     Call(_a(3, 4, lo=-3, hi=3), axis=0, temperature=2.0))
case("log_softmax", Call(_a(3, 4, lo=-3, hi=3)),
     Call(_a(3, 4, lo=-3, hi=3), axis=0))
case("softmin", Call(_a(3, 4, lo=-3, hi=3)),
     Call(_a(3, 4, lo=-3, hi=3), axis=0, temperature=0.5))
case("softmax_cross_entropy", Call(_a(3, 4, lo=-3, hi=3), _f([0, 3, 1]),
                                   grad=(0,)))
case("SoftmaxOutput", Call(_a(3, 4, lo=-3, hi=3), _f([0, 3, 1]), grad=(0,)),
     Call(_a(3, 4, lo=-3, hi=3), _f([0, 3, 1]), grad_scale=2.0,
          normalization="batch", grad=(0,)))
# head dim 16, the smallest the card's kernels take
case("_contrib_flash_attention",
     Call(_a(1, 2, 8, 16), _a(1, 2, 8, 16, seed=1), _a(1, 2, 8, 16, seed=2)),
     Call(_a(1, 2, 8, 16), _a(1, 2, 8, 16, seed=1), _a(1, 2, 8, 16, seed=2),
          causal=True, sm_scale=0.3))
RNN_PARAMS = 4 * 3 * (2 + 3) + 2 * 4 * 3   # lstm, input 2, hidden 3
case("RNN", Call(_a(4, 2, 2), _a(RNN_PARAMS, seed=1), _a(1, 2, 3, seed=2),
                 _a(1, 2, 3, seed=3), state_size=3, num_layers=1,
                 mode="lstm", state_outputs=True))

# the transposed convolution: groups, adj, dilation, target_shape, 3-D,
# and an adj past the stride (which torch's output_padding refuses)
case("Deconvolution",
     Call(_a(2, 4, 3, 3), _a(4, 3, 3, 3, seed=1), _a(6, seed=2),
          kernel=(3, 3), stride=(2, 2), pad=(1, 1), adj=(1, 1),
          num_filter=6, num_group=2, no_bias=False),
     Call(_a(2, 3, 5), _a(3, 2, 3, seed=1), kernel=(3,), stride=(2,),
          dilate=(2,), num_filter=2, target_shape=(12,)),
     Call(_a(1, 2, 2, 3, 2), _a(2, 2, 2, 2, 2, seed=1), kernel=(2, 2, 2),
          stride=(1, 2, 1), num_filter=2),
     Call(_a(2, 2, 4), _a(2, 3, 3, seed=1), kernel=(3,), stride=(2,),
          pad=(1,), adj=(3,), num_filter=3))
# the resizes: growing and shrinking (antialiased), block means
case("UpSampling", Call(_a(2, 3, 3, 4), scale=2, sample_type="nearest"),
     Call(_a(2, 3, 3, 4), scale=3, sample_type="bilinear"))
case("_contrib_BilinearResize2D", Call(_a(2, 3, 4, 5), height=7, width=9),
     Call(_a(1, 2, 8, 8), height=3, width=5),
     Call(_a(1, 2, 6, 4), scale_height=0.5, scale_width=1.5))
case("_contrib_AdaptiveAvgPooling2D",
     Call(_a(2, 3, 6, 4), output_size=(3, 2)),
     Call(_a(2, 3, 7, 5), output_size=(3, 2)), Call(_a(1, 2, 4, 4)),
     Call(_a(1, 2, 4, 4), output_size=2))
# the norms (LayerNorm's mean and std as outputs too)
case("LayerNorm", Call(_a(3, 4, 5, lo=-2, hi=3), _a(5, lo=0.5, hi=1.5),
                       _a(5, seed=1)),
     Call(_a(3, 4, 5, lo=-2, hi=3), _a(4, lo=0.5, hi=1.5), _a(4, seed=1),
          axis=1, eps=1e-3, output_mean_var=True))
case("InstanceNorm", Call(_a(2, 3, 4, 5, lo=-2, hi=3),
                          _a(3, lo=0.5, hi=1.5), _a(3, seed=1)))
case("L2Normalization", *[Call(_a(2, 3, 4, 2), mode=m)
                          for m in ("instance", "channel", "spatial")])
case("LRN", Call(_a(2, 6, 3, 3)), Call(_a(2, 6, 3, 3), nsize=3, alpha=0.1,
                                      beta=0.5, knorm=1.0))
case("LeakyReLU", Call(_away(3, 4), slope=0.1),
     *[Call(_away(3, 4), act_type=t) for t in ("elu", "gelu", "selu",
                                                "rrelu")],
     Call(_away(2, 3, 4), _a(3, seed=1), act_type="prelu"))
case("SoftmaxActivation", Call(_a(2, 3, 4, lo=-3, hi=3)),
     Call(_a(2, 3, 4, lo=-3, hi=3), mode="channel"))
# the loss heads: their gradients ignore the head gradient
for _n in ("LinearRegressionOutput", "MAERegressionOutput",
           "LogisticRegressionOutput"):
    case(_n, Call(_a(3, 4), _a(3, 4, seed=1), grad=(0,)),
         Call(_a(3, 4), _a(3, 4, seed=1), grad_scale=2.5, grad=(0,)))
case("SVMOutput", Call(_a(4, 5, lo=-2, hi=2), _f([0, 3, 1, 4]), grad=(0,)),
     Call(_a(4, 5, lo=-2, hi=2), _f([0, 3, 1, 4]), margin=0.5,
          regularization_coefficient=2.0, use_linear=True, grad=(0,)))
case("MakeLoss", Call(_a(3, 4)), Call(_a(3, 4), grad_scale=0.5,
                                      normalization="batch"))
# CTC: both blank conventions, lengths given, and a -1 pad, which the
# "last" convention reads as a label (a row longer than its frames is
# held to its own bound in tests/test_torch_nn_ops.py)
CTC_FIRST = _f([[1, 2, 2, 0], [3, 0, 0, 0], [4, 1, 3, 2]])
case("CTCLoss", Call(_a(8, 3, 5, lo=-2, hi=2), CTC_FIRST, grad=(0,)),
     Call(_a(8, 3, 5, lo=-2, hi=2), _f([[0, 1, 1, 4], [2, 4, 4, 4],
                                        [3, 0, 2, 1]]),
          blank_label="last", grad=(0,)),
     Call(_a(8, 3, 5, lo=-2, hi=2), CTC_FIRST, _f([8, 6, 7]), _f([2, 1, 3]),
          use_data_lengths=True, use_label_lengths=True, grad=(0,)),
     Call(_a(6, 2, 5, lo=-2, hi=2), _f([[0, 1, -1, -1], [2, 3, 4, 4]]),
          blank_label="last", grad=(0,)))
# the Sequence ops along axis 0 and 1, lengths clamped
SEQ_LEN = _f([2, 4, 1])
for _n in ("SequenceMask", "SequenceLast", "SequenceReverse"):
    case(_n, Call(_a(4, 3, 2)),
         Call(_a(4, 3, 2), SEQ_LEN, use_sequence_length=True, grad=(0,)),
         Call(_a(4, 3, 2), _f([0, 9, 3]), use_sequence_length=True,
              grad=(0,)),
         *([Call(_a(3, 4, 2), SEQ_LEN, use_sequence_length=True, axis=1,
                 grad=(0,))] if _n != "SequenceReverse" else []))
case("_contrib_div_sqrt_dim", Call(_a(2, 3, 8)))
case("_contrib_quadratic", Call(_a(3, 4), a=0.5, b=-1.0, c=2.0))
case("IdentityAttachKLSparseReg", Call(_a(3, 4)))

# ---------------------------------------------------------------------------
# linalg (batched, well-conditioned: symmetric positive definite, or
# triangular with a heavy diagonal)
# ---------------------------------------------------------------------------


def _spd(b, n, seed=0):
    m = _a(b, n, n, seed=seed).astype(np.float64)
    return (m @ m.transpose(0, 2, 1) + n * np.eye(n)).astype(np.float32)


def _tri(b, n, lower=True, seed=0):
    m = np.tril(_a(b, n, n, seed=seed)) if lower else \
        np.triu(_a(b, n, n, seed=seed))
    return (m + 2 * np.eye(n, dtype=np.float32)).astype(np.float32)


def sign_lq(outs):
    """(L, Q) with L's diagonal made positive."""
    lo, q = outs
    d = np.sign(np.diagonal(lo, axis1=-2, axis2=-1))[..., None]
    return [lo * np.swapaxes(d, -1, -2), q * d]


def sign_rows(outs):
    """(U, lambda) with each row of U signed by its largest element."""
    u, w = outs
    big = np.take_along_axis(u, np.abs(u).argmax(-1)[..., None], -1)
    return [u * np.sign(big), w]


case("_linalg_gemm", Call(_a(2, 3, 4), _a(2, 4, 5, seed=1),
                          _a(2, 3, 5, seed=2), alpha=0.5, beta=2.0),
     Call(_a(2, 4, 3), _a(2, 5, 4, seed=1), _a(2, 3, 5, seed=2),
          transpose_a=True, transpose_b=True))
case("_linalg_gemm2", Call(_a(2, 3, 4), _a(2, 4, 5, seed=1), alpha=0.5),
     Call(_a(2, 4, 3), _a(2, 4, 5, seed=1), transpose_a=True),
     Call(_a(3, 4), _a(5, 4, seed=1), transpose_b=True))
case("_linalg_potrf", Call(_spd(2, 4)))
case("_linalg_potri", Call(np.linalg.cholesky(_spd(2, 4)).astype(
    np.float32)))
case("_linalg_trmm", Call(_tri(2, 3), _a(2, 3, 4, seed=1)),
     Call(_tri(2, 3), _a(2, 4, 3, seed=1), rightside=True, transpose=True,
          alpha=2.0))
case("_linalg_trsm", Call(_tri(2, 3), _a(2, 3, 4, seed=1)),
     Call(_tri(2, 3), _a(2, 3, 4, seed=1), transpose=True, alpha=0.5),
     Call(_tri(2, 3), _a(2, 4, 3, seed=1), rightside=True),
     Call(_tri(2, 3, lower=False), _a(2, 4, 3, seed=1), rightside=True,
          transpose=True, lower=False, alpha=-1.5))
case("_linalg_sumlogdiag", Call(_spd(2, 4)))
case("_linalg_syrk", Call(_a(2, 3, 4)), Call(_a(2, 3, 4), transpose=True,
                                             alpha=0.5))
case("_linalg_gelqf", Call(_a(2, 3, 5), grad=(), canon=sign_lq))
case("_linalg_syevd", Call(_spd(2, 4), grad=(), canon=sign_rows))
case("_linalg_makediag", Call(_a(2, 3)), Call(_a(2, 3), offset=1),
     Call(_a(3), offset=-2))
case("_linalg_extractdiag", Call(_a(2, 3, 4)), Call(_a(2, 3, 4), offset=1))
INVERTIBLE = (_a(2, 3, 3, seed=4) + 2 * np.eye(3)).astype(np.float32)
INVERTIBLE[1, 0] *= -1     # a negative determinant
case("_linalg_inverse", Call(INVERTIBLE))
case("_linalg_det", Call(INVERTIBLE))
case("_linalg_slogdet", Call(INVERTIBLE))
case("_contrib_fft", Call(_a(3, 8)))
case("_contrib_ifft", Call(_a(3, 16)))

# optimizer updates: the new values they return
W, G = _a(3, 4), _a(3, 4, seed=1)
case("sgd_update", Call(W, G, lr=0.1, wd=0.01, rescale_grad=0.5))
case("sgd_mom_update", Call(W, G, _a(3, 4, seed=2), lr=0.1, momentum=0.9,
                            wd=0.01, clip_gradient=0.3))
case("adam_update", Call(W, G, _a(3, 4, seed=2), _a(3, 4, lo=0, hi=1,
                                                     seed=3), lr=0.01,
                         wd=0.001))
case("_sparse_adagrad_update", Call(W, G, _a(3, 4, lo=0, hi=1, seed=2),
                                    lr=0.1, wd=0.01))


# the other update ops (float16 weights with float32 masters for the
# mp_ ones)
W16 = W.astype(np.float16)
case("mp_sgd_update", Call(W16, G.astype(np.float16), W, lr=0.1, wd=0.01,
                           rescale_grad=0.5, clip_gradient=0.3))
case("mp_sgd_mom_update", Call(W16, G.astype(np.float16), _a(3, 4, seed=2),
                               W, lr=0.1, momentum=0.9, wd=0.01))
case("nag_mom_update", Call(W, G, _a(3, 4, seed=2), lr=0.1, momentum=0.9,
                            wd=0.01, clip_gradient=0.3, rescale_grad=0.5))
case("ftml_update", Call(W, G, _a(3, 4, lo=0, hi=1, seed=2),
                         _a(3, 4, lo=0, hi=1, seed=3), _a(3, 4, seed=4),
                         lr=0.01, t=3, wd=0.01, clip_grad=0.4),
     Call(W, G, _a(3, 4, lo=0, hi=1, seed=2), _a(3, 4, lo=0, hi=1, seed=3),
          _a(3, 4, seed=4), lr=0.01, t=1, clip_gradient=0.2, clip_grad=0.4))
case("ftrl_update", Call(W, G, _a(3, 4, seed=2), _a(3, 4, lo=0, hi=1, seed=3),
                         lr=0.1, lamda1=0.3, wd=0.01))
case("rmsprop_update", Call(W, G, _a(3, 4, lo=0, hi=1, seed=2), lr=0.01,
                            wd=0.01, clip_weights=0.5))
case("rmspropalex_update", Call(W, G, _a(3, 4, lo=0.5, hi=1, seed=2),
                                _a(3, 4, lo=-0.1, hi=0.1, seed=3),
                                _a(3, 4, seed=4), lr=0.01, wd=0.01,
                                clip_weights=0.8))
case("signsgd_update", Call(W, G, lr=0.1, wd=0.01))
case("signum_update", Call(W, G, _a(3, 4, seed=2), lr=0.1, momentum=0.9,
                           wd=0.01, wd_lh=0.05))
case("adadelta_update", Call(W, G, _a(3, 4, lo=0, hi=1, seed=2),
                             _a(3, 4, lo=0, hi=1, seed=3), wd=0.01))
case("_contrib_group_adagrad_update",
     Call(W, G, _a(3, lo=0, hi=1, seed=2), lr=0.1, clip_gradient=0.5),
     Call(_a(2, 3, 2), _a(2, 3, 2, seed=1), _a(2, lo=0, hi=1, seed=2),
          lr=0.1))


# ---------------------------------------------------------------------------
# control flow: the subgraphs are built by each package's front end,
# and the node's attrs handed to the op (inputs: data, states, free
# variables in the subgraph's order, aux)
# ---------------------------------------------------------------------------

def node_attrs(make):
    """A ``build`` for Call: the attrs of the control-flow node that
    ``make(mx)`` returns a Symbol of."""
    def build(mx):
        out = make(mx)
        return dict(out[0]._outputs[0][0].attrs if isinstance(out, list)
                    else out._outputs[0][0].attrs)
    return build


def _foreach_rnn(mx):
    s = mx.sym
    w = s.var("w")
    return mx.sym.contrib.foreach(
        lambda xt, h: (s.tanh(s.dot(xt, w) + h) * 2, s.tanh(s.dot(xt, w) + h)),
        s.var("x"), s.var("h"))[0]


def _while_doubling(mx):
    s = mx.sym
    return mx.sym.contrib.while_loop(
        lambda i, a: s.sum(i) < 40, lambda i, a: ([i * a], [i * 2, a + 1]),
        [s.var("i"), s.var("a")], max_iterations=8)[0]


def _cond_square(mx):
    s = mx.sym
    a = s.var("a")
    return mx.sym.contrib.cond(s.var("p"), lambda: a * a,
                               lambda: s.var("b") + 1)


case("_foreach", Call(_a(4, 2, 3), _a(2, 5, seed=1), _a(3, 5, seed=2),
                      build=node_attrs(_foreach_rnn)))
# no gradient: the loop's trip count depends on the data (as in the JAX
# package, whose lax.while_loop has no reverse mode)
case("_while_loop", Call(_f([1.5]), _f([1, 2, 0.5]), grad=(),
                         build=node_attrs(_while_doubling)))
case("_cond", *[Call(_f([p]), _a(3, 4, seed=1), _a(3, 4, seed=2),
                     grad=(1, 2), build=node_attrs(_cond_square))
                for p in (1, 0)])

# ---------------------------------------------------------------------------
# image ops: HWC and NHWC, uint8 and float; the random flips on images
# that their flip leaves as they are (their rate is held in
# tests/test_torch_image.py)
# ---------------------------------------------------------------------------

def _u8(*shape, seed=0):
    return np.random.RandomState(seed).randint(0, 256, shape) \
        .astype(np.uint8)


def _mirrored(x, axis):
    return np.concatenate([x, np.flip(x, axis)], axis=axis)


case("_image_to_tensor", Call(_u8(4, 5, 3)), Call(_a(2, 4, 5, 3, lo=0,
                                                     hi=255)))
case("_image_normalize",
     Call(_a(3, 4, 5), mean=(0.1, 0.2, 0.3), std=(0.5, 0.6, 0.7)),
     Call(_a(2, 3, 4, 5), mean=(0.4914, 0.4822, 0.4465),
          std=(0.2023, 0.1994, 0.2010)),
     Call(_a(2, 1, 4, 5), mean=(0.5,), std=(2.0,)))
for _n in ("_image_flip_left_right", "_image_flip_top_bottom"):
    case(_n, Call(_u8(4, 5, 3), exact=True),
         Call(_a(2, 4, 5, 3), exact=True))
case("_image_random_flip_left_right",
     Call(_mirrored(_u8(4, 3, 3), 1), exact=True),
     Call(_mirrored(_a(2, 4, 3, 3), 2), exact=True))
case("_image_random_flip_top_bottom",
     Call(_mirrored(_u8(3, 5, 3), 0), exact=True),
     Call(_mirrored(_a(2, 3, 5, 3), 1), exact=True))
# growing, shrinking (antialiased), nearest; uint8 in tests/test_torch_image.py
case("_image_resize", Call(_a(4, 5, 3), size=(7, 6)),
     Call(_a(2, 9, 8, 3), size=(3, 4)),
     Call(_a(5, 4, 2), size=(6, 9), interp=0),
     Call(_a(2, 6, 6, 1), size=4))
case("_image_crop", Call(_u8(6, 7, 3), x=1, y=2, width=3, height=2,
                         exact=True),
     Call(_a(2, 6, 7, 3), x=0, y=1, width=5, height=4, exact=True))
case("_cvimresize", Call(_a(6, 5, 3), w=9, h=4), Call(_a(8, 8, 3), w=3,
                                                      h=5))
case("_cvcopyMakeBorder",
     *[Call(_u8(3, 4, 2), top=1, bot=2, left=3, right=0, type=t,
            exact=True) for t in (1, 2, 4)],
     # pads wider than the image: numpy reflects again
     *[Call(_a(2, 3, 3), top=5, bot=4, left=7, right=3, type=t,
            exact=True) for t in (2, 4)],
     Call(_u8(3, 4, 2), top=2, bot=1, left=1, right=2, type=0, value=7.0,
          exact=True),
     Call(_a(3, 4, 3), top=1, bot=1, left=2, right=2, type=0,
          values=(1.5, -2.0), exact=True))
# the lookup; its weight's gradient (row-sparse, recorded imperatively)
# densified
case("_contrib_SparseEmbedding",
     Call(_f([[0, 3, 3], [5, 1, 0]]), _a(6, 4), input_dim=6, output_dim=4,
          grad=(1,)),
     Call(_f([2, 9, -1]), _a(6, 4, seed=1), input_dim=6, output_dim=4,
          grad=(1,)))


# ---------------------------------------------------------------------------
# detection (contrib, vision, rcnn): boxes clustered so that NMS
# suppresses, pooling bins with tied maxima, ROIs past the image and
# degenerate, the shared best anchor of MultiBoxTarget
# ---------------------------------------------------------------------------


def boxes_near(n, seed=0, centers=3, span=1.0):
    """n corner boxes (x1, y1, x2, y2) clustered around a few centres."""
    rng = np.random.RandomState(seed)
    c = rng.uniform(0.25, 0.75, (centers, 2))[rng.randint(0, centers, n)]
    c = c + rng.normal(0, 0.04, (n, 2))
    wh = rng.uniform(0.15, 0.4, (n, 2))
    return (np.concatenate([c - wh / 2, c + wh / 2], 1) * span) \
        .astype(np.float32)


def relu_ties(*shape, seed=0):
    """Halves in [0, 2], about a third of them 0: ties inside a bin."""
    x = np.round(_a(*shape, lo=-1, hi=2, seed=seed) * 2) / 2
    return np.maximum(x, 0).astype(np.float32)


def nms_rows(b, n, seed=0):
    """(b, n, 6) rows [class, score, x1, y1, x2, y2], two scores tied."""
    rng = np.random.RandomState(seed)
    rows = np.concatenate([rng.randint(0, 2, (b, n, 1)),
                           rng.uniform(0, 1, (b, n, 1)),
                           boxes_near(b * n, seed).reshape(b, n, 4)], 2)
    rows[:, 1, 1] = rows[:, 0, 1]
    return rows.astype(np.float32)


# [batch, x1, y1, x2, y2] in image coordinates (twice the map's): inside,
# past the image, fractional, negative, degenerate (x2 < x1)
ROIS = _f([[0, 1, 2, 9, 7], [1, 0, 0, 15, 11], [0, 6.4, 3.5, 7.6, 4.5],
           [1, -4, -3, 3, 2], [0, 12, 8, 30, 30], [1, 5, 5, 4, 4]])
FRAC_ROIS = _f([[0, 1.3, 2.2, 9.1, 7.7], [1, 0.4, 0.6, 11.2, 9.3],
                [0, 6.4, 3.5, 7.6, 4.5], [1, -1.7, -0.9, 3.3, 2.1]])
case("ROIPooling",
     Call(relu_ties(2, 3, 6, 8), ROIS, pooled_size=(3, 2),
          spatial_scale=0.5, grad=(0,)),
     Call(_a(2, 2, 7, 9, seed=1), ROIS, pooled_size=(2, 2), grad=(0,)))
case("_contrib_ROIAlign",
     Call(_a(2, 3, 6, 7), FRAC_ROIS, pooled_size=(1, 2), spatial_scale=0.5),
     Call(_a(2, 3, 6, 7), FRAC_ROIS, pooled_size=(2, 1), spatial_scale=0.5,
          sample_ratio=1, aligned=True))
case("_contrib_box_iou", Call(boxes_near(4), boxes_near(5, seed=1)),
     Call(_a(3, 4, lo=0.3, hi=1.0), _a(2, 4, lo=0.3, hi=1.0, seed=1),
          format="center"))
case("_contrib_box_nms", Call(nms_rows(2, 12)),
     Call(nms_rows(2, 12, seed=1), overlap_thresh=0.3, id_index=0,
          valid_thresh=0.2),
     Call(nms_rows(1, 10, seed=2), id_index=0, force_suppress=True,
          in_format="center"))
case("_contrib_bipartite_matching",
     Call(_a(2, 4, 5, seed=3), threshold=0.1, exact=True),
     Call(_a(5, 3, seed=4), is_ascend=True, threshold=0.2, topk=2,
          exact=True))
case("_contrib_MultiBoxPrior",
     Call(_a(1, 2, 3, 4), sizes=(0.3, 0.5), ratios=(1.0, 2.0, 0.5),
          exact=True),
     Call(_a(2, 1, 3, 2), sizes=(0.6,), ratios=(1.0, 3.0), clip=True,
          steps=(0.25, 0.2), offsets=(0.3, 0.6), exact=True))
case("_contrib_SyncBatchNorm",
     Call(_a(4, 3, 2, 2, lo=-2, hi=3), _a(3, lo=0.5, hi=1.5), _a(3, seed=1),
          np.zeros(3, np.float32), np.ones(3, np.float32), fix_gamma=False,
          grad=(0, 1, 2)))
case("_contrib_arange_like", Call(_a(2, 3), exact=True),
     Call(_a(2, 5), start=1.0, step=0.5, repeat=2, exact=True),
     Call(_a(3, 4), axis=1, step=2.0, exact=True))

case("GridGenerator",
     Call(_a(2, 6), transform_type="affine", target_shape=(3, 4)),
     Call(_a(2, 2, 3, 4, lo=-2, hi=2), transform_type="warp"))
# taps past the image, and a grid on whole pixels ((g + 1) * 2 an integer
# on a 5 x 5 map), where a tap's weight is 0 or 1
ON_PIXELS = np.random.RandomState(6).choice(
    [-1.0, -0.5, 0.0, 0.5, 1.0], (2, 2, 3, 4)).astype(np.float32)
case("BilinearSampler",
     Call(_a(2, 3, 4, 5), _a(2, 2, 3, 4, lo=-1.3, hi=1.3, seed=1)),
     Call(_a(2, 3, 5, 5), ON_PIXELS))
case("SpatialTransformer",
     Call(_a(2, 3, 5, 6), (_f([1, 0, 0, 0, 1, 0]) + _a(2, 6, lo=-0.3,
                                                        hi=0.3, seed=1)),
          target_shape=(4, 5)))
# an even kernel: XLA's SAME pads (k - 1) // 2 before and k // 2 after
case("Correlation",
     Call(_a(1, 3, 6, 7), _a(1, 3, 6, 7, seed=1), max_displacement=2),
     Call(_a(1, 2, 7, 7), _a(1, 2, 7, 7, seed=1), kernel_size=3,
          max_displacement=2, stride1=2, stride2=2, pad_size=2),
     Call(_a(2, 2, 5, 6), _a(2, 2, 5, 6, seed=1), kernel_size=2,
          max_displacement=1, pad_size=1, is_multiply=False))

ANCHORS = boxes_near(24, seed=5)[None]
# image 0: gt 1 is anchor 3 itself and gt 0 nearly so: both claim anchor 3
# (the later box keeps it); image 1: a valid box whose best anchor is 0,
# then two pads, whose columns of -1 point at anchor 0 too (their later
# writes unclaim it)
MB_LABELS = np.full((2, 3, 5), -1.0, np.float32)
MB_LABELS[0, 0] = [1] + list(ANCHORS[0, 3] + 0.01)
MB_LABELS[0, 1] = [0] + list(ANCHORS[0, 3])
MB_LABELS[0, 2] = [1] + list(boxes_near(1, seed=9)[0])
MB_LABELS[1, 0] = [0] + list(ANCHORS[0, 0] + 0.01)   # IoU under 0.95
case("_contrib_MultiBoxTarget",
     Call(ANCHORS, MB_LABELS, _a(2, 3, 24, seed=2)),
     Call(ANCHORS, MB_LABELS, _a(2, 3, 24, seed=2), overlap_threshold=0.3,
          variances=(0.2, 0.2, 0.5, 0.5)))


def class_probs(b, c, n, seed=0):
    e = np.exp(_a(b, c, n, lo=-2, hi=2, seed=seed))
    return (e / e.sum(1, keepdims=True)).astype(np.float32)


case("_contrib_MultiBoxDetection",
     Call(class_probs(2, 3, 24), _a(2, 96, lo=-0.5, hi=0.5), ANCHORS),
     Call(class_probs(2, 3, 24, seed=1), _a(2, 96, lo=-0.5, hi=0.5, seed=1),
          ANCHORS, force_suppress=True, clip=False, threshold=0.3,
          nms_threshold=0.3))

# the rois within float32's bound (the decoding's exp rounds apart); the
# picks, and so the scores, equal
PROP = dict(rpn_pre_nms_top_n=20, rpn_post_nms_top_n=8, threshold=0.6,
            rpn_min_size=4, scales=(2.0, 4.0), ratios=(0.5, 1.0),
            feature_stride=8)
case("_contrib_Proposal",
     Call(_a(1, 8, 4, 5, lo=0, hi=1), _a(1, 16, 4, 5, lo=-0.3, hi=0.3),
          _f([[28, 40, 1.0]]), output_score=True, **PROP),
     Call(_a(1, 8, 4, 5, lo=0, hi=1, seed=1),
          _a(1, 16, 4, 5, lo=-3, hi=3, seed=1), _f([[32, 36, 2.0]]),
          iou_loss=True, **PROP))
case("_contrib_MultiProposal",
     Call(_a(2, 8, 4, 5, lo=0, hi=1, seed=2),
          _a(2, 16, 4, 5, lo=-0.3, hi=0.3, seed=2),
          _f([[32, 40, 1.0], [20, 28, 1.5]]), output_score=True, **PROP))
case("_contrib_PSROIPooling",
     Call(_a(2, 18, 6, 7), ROIS, spatial_scale=0.5, output_dim=2,
          pooled_size=3, grad=(0,)),
     Call(_a(2, 8, 5, 5), ROIS, spatial_scale=0.25, output_dim=2,
          pooled_size=3, group_size=2, grad=(0,)))
case("_contrib_DeformableConvolution",
     Call(_a(1, 4, 5, 5), _a(1, 36, 5, 5, lo=-1.5, hi=1.5, seed=1),
          _a(4, 2, 3, 3, seed=2), _a(4, seed=3), kernel=(3, 3), pad=(1, 1),
          num_filter=4, num_group=2, num_deformable_group=2),
     Call(_a(2, 2, 6, 5), _a(2, 8, 2, 2, lo=-2, hi=2, seed=1),
          _a(3, 2, 2, 2, seed=2), kernel=(2, 2), stride=(2, 2),
          dilate=(2, 1), num_filter=3, no_bias=True))
case("_contrib_DeformablePSROIPooling",
     Call(_a(2, 18, 6, 7), ROIS, _a(6, 4, 3, 3, lo=-1, hi=1, seed=1),
          spatial_scale=0.5, output_dim=2, group_size=3, pooled_size=3,
          part_size=3, sample_per_part=2, trans_std=0.1, grad=(0, 2)),
     Call(_a(2, 18, 6, 7), ROIS, spatial_scale=0.5, output_dim=2,
          group_size=3, pooled_size=3, sample_per_part=2, no_trans=True,
          grad=(0,)))

# random draws: finiteness and moments (name -> attrs, mean, std, the
# parameter arrays of a _sample_ op); a _like op draws in the shape and
# dtype of its input
MOMENTS = {"_random_uniform": (dict(low=-1.0, high=3.0), 1.0,
                               4 / np.sqrt(12), ()),
           "_random_normal": (dict(loc=2.0, scale=0.5), 2.0, 0.5, ()),
           "_random_gamma": (dict(alpha=2.0, beta=1.5), 3.0,
                             1.5 * np.sqrt(2), ()),
           "_random_exponential": (dict(lam=2.0), 0.5, 0.5, ()),
           "_random_poisson": (dict(lam=3.0), 3.0, np.sqrt(3), ()),
           "_random_negative_binomial": (dict(k=3, p=0.4), 4.5,
                                         np.sqrt(11.25), ()),
           "_random_generalized_negative_binomial": (
               dict(mu=2.0, alpha=0.5), 2.0, 2.0, ()),
           "_random_randint": (dict(low=-3, high=5), 0.5, np.sqrt(5.25), ())}
for _n in list(MOMENTS):
    if _n not in ("_random_randint",):
        MOMENTS[_n + "_like"] = MOMENTS[_n]
MOMENTS.update({
    "_sample_uniform": ({}, 1.0, 4 / np.sqrt(12), ([-1.0], [3.0])),
    "_sample_normal": ({}, 2.0, 0.5, ([2.0], [0.5])),
    "_sample_gamma": ({}, 3.0, 1.5 * np.sqrt(2), ([2.0], [1.5])),
    "_sample_exponential": ({}, 0.5, 0.5, ([2.0],)),
    "_sample_poisson": ({}, 3.0, np.sqrt(3), ([3.0],)),
    "_sample_negative_binomial": ({}, 4.5, np.sqrt(11.25), ([3.0], [0.4])),
    "_sample_generalized_negative_binomial": ({}, 2.0, 2.0, ([2.0],
                                                              [0.5]))})
# draws held by their contracts (random_contracts), not by moments
CONTRACTS = ("_sample_multinomial", "_sample_unique_zipfian", "_shuffle",
             "_contrib_dgl_csr_neighbor_uniform_sample",
             "_contrib_dgl_csr_neighbor_non_uniform_sample")
for _n in list(MOMENTS) + list(CONTRACTS):
    case(_n)


def draw(mx, name, n, ctx):
    """``n`` draws of the MOMENTS row ``name`` on ``ctx`` as a flat numpy
    array, and the dtype they must have."""
    attrs, _, _, params = MOMENTS[name]
    fn = getattr(mx.nd, name)
    if name.endswith("_like"):
        out = fn(mx.nd.zeros((n,), ctx=ctx), **attrs)
    elif params:
        out = fn(*[mx.nd.array(np.asarray(p, np.float32), ctx=ctx)
                   for p in params], shape=(n,), **attrs)
        assert out.shape == (1, n), out.shape
    else:
        out = fn(shape=(n,), ctx=ctx, **attrs)
    want = np.int32 if name == "_random_randint" else np.float32
    return out.asnumpy().reshape(-1), want


def moment_errors(x, mean, std):
    """(the sample mean's error, the sample variance's error), each in
    standard errors of that estimate (the variance's from the sample's
    fourth central moment)."""
    x = np.asarray(x, np.float64)
    n, m = x.size, x.mean()
    var = x.var()
    m4 = ((x - m) ** 4).mean()
    se_var = np.sqrt(max(m4 - var ** 2, 1e-300) / n)
    return (abs(m - mean) / (std / np.sqrt(n)),
            abs(var - std ** 2) / se_var)


def random_contracts(mx, ctx):
    """The contracts of the draws that moments do not hold: (name,
    failure or None) for each of CONTRACTS."""
    out = []
    mx.random.seed(11)
    p = np.array([[0.1, 0.2, 0.7, 0.0], [0.25, 0.25, 0.25, 0.25]],
                 np.float32)
    d, lp = mx.random.multinomial(mx.nd.array(p, ctx=ctx), shape=5000,
                                  get_prob=True)
    d, lp = d.asnumpy(), lp.asnumpy()
    flat = mx.nd._sample_multinomial(mx.nd.array(p[0], ctx=ctx), shape=7)
    freq = np.stack([np.bincount(r, minlength=4) / r.size for r in d])
    bad = None
    if d.shape != (2, 5000) or d.dtype != np.int32 or flat.shape != (7,):
        bad = "shapes %s %s dtype %s" % (d.shape, flat.shape, d.dtype)
    elif np.abs(freq - p).max() > 4 * np.sqrt(0.25 / 5000) or freq[0, 3]:
        bad = "frequencies %s" % freq.tolist()
    elif not np.allclose(lp, np.log(np.take_along_axis(p, d, 1)),
                         atol=1e-6):
        bad = "get_prob is not the log-probability of the draws"
    out.append(("_sample_multinomial", bad))
    z = mx.nd._sample_unique_zipfian(range_max=50, shape=(400, 10),
                                     ctx=ctx).asnumpy()
    bad = None
    counts = np.bincount(z.reshape(-1), minlength=50)
    if z.shape != (400, 10) or z.dtype != np.int32:
        bad = "shape %s dtype %s" % (z.shape, z.dtype)
    elif any(len(set(r)) != 10 for r in z) or z.min() < 0 or z.max() >= 50:
        bad = "rows not unique or out of range"
    elif not (counts[:5] > counts[-5:].max()).all():
        bad = "not log-uniform: counts %s" % counts.tolist()
    else:
        try:
            mx.nd._sample_unique_zipfian(range_max=5, shape=(6,), ctx=ctx)
            bad = "6 unique draws from 5 classes did not raise"
        except ValueError:
            pass
    out.append(("_sample_unique_zipfian", bad))
    x = np.arange(60, dtype=np.float32).reshape(20, 3)
    s = mx.nd._shuffle(mx.nd.array(x, ctx=ctx)).asnumpy()
    bad = None
    if s.shape != x.shape or sorted(map(tuple, s)) != sorted(map(tuple, x)):
        bad = "not a permutation of the rows"
    elif np.array_equal(s, x):
        bad = "the rows stayed in order"
    out.append(("_shuffle", bad))
    return out + dgl_contracts(mx, ctx)


# outside training Dropout is the identity; its draws are held by
# moments where it trains
case("Dropout", Call(_a(3, 4), p=0.5, grad=()))


# ---------------------------------------------------------------------------
# INT8 quantization: int8 data and weights, the (1,) ranges the
# quantization pass feeds; every integer result is held equal (K = 27
# is not a multiple of 8: the card pads it)
# ---------------------------------------------------------------------------

def _i8(*shape, seed=0):
    return np.random.RandomState(seed).randint(-127, 128, shape) \
        .astype(np.int8)


def _ranges(*pairs):
    return [_f([v]) for pair in pairs for v in pair]


QD, QW, QB = (-0.9, 1.1), (-0.4, 0.3), (-0.2, 0.25)

case("_contrib_quantize",
     Call(_a(3, 4), _f([-0.7]), _f([0.9])),
     Call(_a(3, 4, seed=1), _f([0.1]), _f([0.9]), out_type="uint8"))
case("_contrib_quantize_v2",
     Call(_a(3, 4)),
     Call(_a(3, 5, seed=1), min_calib_range=-0.5, max_calib_range=0.6),
     Call(_a(2, 5, seed=2), out_type="uint8"))
case("_contrib_dequantize",
     Call(_i8(3, 4), _f([-0.7]), _f([0.9])),
     Call(np.random.RandomState(1).randint(-2 ** 31 + 1, 2 ** 31 - 1, (3, 4))
          .astype(np.int32), _f([-3.0]), _f([3.0])),
     Call(np.random.RandomState(2).randint(0, 256, (3, 4)).astype(np.uint8),
          _f([0.1]), _f([2.0])))
case("_contrib_requantize",
     Call(np.random.RandomState(3).randint(-2 ** 30, 2 ** 30, (3, 4))
          .astype(np.int32), _f([-50.0]), _f([50.0])),
     Call(np.random.RandomState(4).randint(-2 ** 30, 2 ** 30, (2, 5))
          .astype(np.int32), _f([-50.0]), _f([50.0]),
          min_calib_range=-20.0, max_calib_range=25.0))
case("_contrib_quantized_fully_connected",
     Call(_i8(5, 3, 9), _i8(7, 27, seed=1), _i8(7, seed=2),
          *_ranges(QD, QW), num_hidden=7),
     Call(_i8(20, 27, seed=3), _i8(16, 27, seed=4), _i8(16, seed=5),
          *_ranges(QD, QW, QB), num_hidden=16),
     Call(_i8(2, 4, 8, seed=6), _i8(3, 8, seed=7), _i8(3, seed=8),
          *_ranges(QD, QW), num_hidden=3, flatten=False, no_bias=True))
case("_contrib_quantized_conv",
     Call(_i8(2, 3, 6, 6), _i8(4, 3, 3, 3, seed=1), _i8(4, seed=2),
          *_ranges(QD, QW), kernel=(3, 3), pad=(1, 1), num_filter=4),
     Call(_i8(2, 4, 7, 7, seed=3), _i8(6, 2, 3, 3, seed=4), _i8(6, seed=5),
          *_ranges(QD, QW, QB), kernel=(3, 3), stride=(2, 2),
          dilate=(2, 2), pad=(2, 2), num_filter=6, num_group=2),
     Call(_i8(2, 8, 4, 4, seed=6), _i8(8, 8, 1, 1, seed=7), _i8(8, seed=8),
          *_ranges(QD, QW), kernel=(1, 1), num_filter=8, no_bias=True),
     Call(_i8(2, 3, 10, seed=9), _i8(5, 3, 3, seed=10), _i8(5, seed=11),
          *_ranges(QD, QW), kernel=(3,), stride=(2,), num_filter=5))
case("_contrib_quantized_pooling",
     Call(_i8(2, 3, 6, 6), *_ranges(QD), kernel=(2, 2), stride=(2, 2),
          pool_type="max"),
     Call(_i8(2, 3, 7, 7, seed=1), *_ranges(QD), kernel=(3, 3),
          stride=(2, 2), pad=(1, 1), pool_type="avg"),
     Call(_i8(2, 3, 5, 5, seed=2), *_ranges(QD), kernel=(1, 1),
          global_pool=True, pool_type="avg"))
case("_contrib_quantized_flatten", Call(_i8(2, 3, 4), *_ranges(QD)))
case("_contrib_quantized_concat",
     Call(_i8(2, 3, 4), _i8(2, 2, 4, seed=1), _f([-0.5]), _f([-0.9]),
          _f([0.7]), _f([0.4]), dim=1, num_args=2))

# ---------------------------------------------------------------------------
# dgl: a dense edge-id graph (A[u, v] = edge id + 1), -1-padded vertex
# lists; the samplers' draws are held by their contracts (dgl_contracts)
# ---------------------------------------------------------------------------

def edge_id_graph(v, p, seed=0):
    """A (v, v) float32 edge-id graph without self-loops, ids in row
    order."""
    rng = np.random.RandomState(seed)
    adj = (rng.uniform(size=(v, v)) < p) & ~np.eye(v, dtype=bool)
    g = np.zeros((v, v), np.float32)
    g[adj] = np.arange(1, adj.sum() + 1)
    return g


GRAPH = edge_id_graph(6, 0.4)


def _ids(values):
    return np.asarray(values, np.int32)


case("_contrib_edge_id",
     Call(GRAPH, _ids([0, 1, 2, 5, 3]), _ids([1, 3, 0, 5, 4])))
case("_contrib_dgl_adjacency", Call(GRAPH))
case("_contrib_dgl_subgraph",
     Call(GRAPH, _ids([0, 2, 3, -1]), _ids([1, 4, -1, -1]), num_args=3,
          return_mapping=True),
     Call(GRAPH, _ids([5, 0, 1]), num_args=2))
case("_contrib_dgl_graph_compact",
     Call(GRAPH, edge_id_graph(6, 0.5, seed=1), num_args=3,
          return_mapping=True, graph_sizes=(4, 6)))
case("_copyto", Call(_a(3, 4)))
case("_scatter_elemwise_div", Call(_a(3, 4), _away(3, 4, seed=1)))


def _sampler_bad(g, seeds, out, hops, k):
    """What breaks the sampler's contract in ``out`` (vertices, subgraph,
    layers[, weights]), or None."""
    verts, sub, lay = (np.asarray(o) for o in out[:3])
    valid = verts >= 0
    n = int(valid.sum())
    if not valid[:n].all() or len(set(verts[:n])) != n:
        return "the vertices are not distinct ids followed by -1s"
    vs, ls = verts[:n], lay[:n]
    if (lay[n:] != -1).any() or (np.diff(ls) < 0).any():
        return "the layers do not rise"
    real = [s for s in seeds if s >= 0]
    if sorted(vs[ls == 0]) != sorted(set(real)):
        return "layer 0 is not the seeds"
    for h in range(1, hops + 1):
        prev, cur = vs[ls == h - 1], vs[ls == h]
        if len(cur) > k * len(prev):
            return "hop %d added %d vertices from %d" % (h, len(cur),
                                                          len(prev))
        if any(not (g[prev, v] != 0).any() for v in cur):
            return "a vertex of hop %d has no edge from hop %d" % (h, h - 1)
    vc = np.clip(verts, 0, len(g) - 1)
    want = (g[vc][:, vc] != 0) & valid[:, None] & valid[None, :]
    if not np.array_equal(sub != 0, want):
        return "the subgraph is not the one the vertices induce"
    return None


def dgl_contracts(mx, ctx):
    """The neighbor samplers' contracts: each sampled vertex reached by an
    edge from the hop before, at most ``num_neighbor`` new vertices a
    frontier vertex, the induced subgraph, the weights of the vertices;
    and their draws: on a star of 10 neighbors, each picked 2 times in
    10 by the uniform sampler, and with one pick its weight's share by
    the weighted one (the exponential race), within 5 standard errors
    over 300 calls."""
    out = []
    g = edge_id_graph(40, 0.15, seed=5)
    prob = np.random.RandomState(6).uniform(0.1, 1.0, 40).astype(np.float32)
    seeds = _ids([0, 5, -1])
    G = mx.nd.array(g, ctx=ctx)
    S = mx.nd.array(seeds, ctx=ctx, dtype=np.int32)
    P = mx.nd.array(prob, ctx=ctx)
    nd = mx.nd.contrib
    star = np.zeros((11, 11), np.float32)
    star[0, 1:] = np.arange(1, 11)
    weights = np.concatenate([[1.0], np.arange(1, 11)]).astype(np.float32)
    Gs, W = mx.nd.array(star, ctx=ctx), mx.nd.array(weights, ctx=ctx)
    S0 = mx.nd.array(_ids([0]), ctx=ctx, dtype=np.int32)
    calls = 300
    for name, fn, extra, k in (
            ("_contrib_dgl_csr_neighbor_uniform_sample",
             nd.dgl_csr_neighbor_uniform_sample, [], 2),
            ("_contrib_dgl_csr_neighbor_non_uniform_sample",
             nd.dgl_csr_neighbor_non_uniform_sample, [P], 1)):
        res = [o.asnumpy() for o in fn(G, *extra, S, num_hops=2,
                                      num_neighbor=3, max_num_vertices=30)]
        bad = _sampler_bad(g, seeds, res, 2, 3)
        if bad is None and extra:
            v = res[0]
            want = np.where(v >= 0, prob[np.clip(v, 0, 39)], 0.0)
            if not np.array_equal(res[3], want):
                bad = "the weights are not the vertices' probabilities"
        if bad is None:
            counts = np.zeros(11)
            for _ in range(calls):
                v = fn(Gs, *([W] if extra else []), S0, num_hops=1,
                       num_neighbor=k, max_num_vertices=11)[0].asnumpy()
                counts[v[v > 0]] += 1
            share = np.full(10, 0.2) if not extra else \
                weights[1:] / weights[1:].sum()
            se = np.sqrt(calls * share * (1 - share))
            if (np.abs(counts[1:] - calls * share) > 5 * se).any():
                bad = "picks %s, expected %s" % (counts[1:].tolist(),
                                                 (calls * share).tolist())
        out.append((name, bad))
    return out


# ---------------------------------------------------------------------------
# Custom and _subgraph_exec: the prop and the subgraph made by each
# package
# ---------------------------------------------------------------------------

def _custom_attrs(mx):
    """Register (once) a two-input, two-output Python op in ``mx``."""
    name = "op_cases_square_shift"
    if name not in mx.operator.get_all_registered_operators():
        class Op(mx.operator.CustomOp):
            def forward(self, is_train, req, in_data, out_data, aux):
                x, y = in_data
                self.assign(out_data[0], req[0], x * x * 0.5 + y)
                self.assign(out_data[1], req[1], x * 3)

            def backward(self, req, out_grad, in_data, out_data, in_grad,
                         aux):
                self.assign(in_grad[0], req[0],
                            out_grad[0] * in_data[0] + out_grad[1] * 3)
                self.assign(in_grad[1], req[1], out_grad[0])

        @mx.operator.register(name)
        class Prop(mx.operator.CustomOpProp):
            def list_arguments(self):
                return ["data", "shift"]

            def list_outputs(self):
                return ["out", "triple"]

            def infer_shape(self, in_shape):
                return in_shape, [in_shape[0], in_shape[0]], []

            def create_operator(self, ctx, shapes, dtypes):
                return Op()
    return {"op_type": name}


def _subgraph_attrs(mx):
    s = mx.sym
    x, y = s.var("x"), s.var("y")
    g = s.Group([s.tanh(x) * y, s.relu(x) + y])
    return {"subgraph_json": g.tojson(), "n_out": 2}


case("Custom", Call(_a(3, 4), _a(3, 4, seed=1), build=_custom_attrs))
case("_subgraph_exec", Call(_a(3, 4), _a(3, 4, seed=1),
                            build=_subgraph_attrs))
