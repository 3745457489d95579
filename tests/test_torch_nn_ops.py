"""The PyTorch port's nn ops past the ResNet set (`mxtpu_torch/ops/nn.py`)
against the JAX package's (`mxtpu/ops/nn.py`), op by op at the
registry: the same numpy inputs through the JAX function under
`jax.vjp` and the port's under torch autograd, with the same head
gradients (normal draws from seeds 7, 8...).  Every output and every
input gradient must agree within `RTOL` (1e-5) of the reference's
value plus `ATOL` (1e-6) of the result's largest magnitude: float32
arithmetic in other orders (`test_torch_op_cases.error_units`).

Beside the op sweep (`test_torch_ops*.py`), which runs the canonical
names through `nd`, this file runs every one of the 25 names and the
cases each op's semantics turn on: Deconvolution in 1-D, 2-D and 3-D
with stride, pad, adj (also past the stride), dilation, groups and
`target_shape`; the heads' gradients, which do not read the head
gradient; the norms, the resizes growing and shrinking, the Sequence
ops (`OPS`, run by `test_torch_nn_ops_b.py`; CTC is in
`test_torch_ctc.py`).  Last, the symbolic side: each new op with
parameters or labels composed as a Symbol infers the reference's
argument names and shapes.
"""
import jax
import numpy as np
import pytest
import torch

import mxtpu as jmx
import mxtpu_torch as tmx
from mxtpu.ops import registry as jreg
from mxtpu_torch.ops import registry as treg
from test_torch_op_cases import _a, _away, _f, error_units

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


def _heads(outs, seed=7):
    return [np.random.RandomState(seed + k).normal(0, 1, np.shape(o))
            .astype(np.float32) for k, o in enumerate(outs)]


def reference(name, inputs, attrs, grad, heads=None):
    """(outputs, gradients of the inputs ``grad``) of the JAX op under
    ``jax.vjp``."""
    fn = jreg.get_op(name).fn
    xs = [jax.numpy.asarray(x) for x in inputs]

    def f(*g):
        args = list(xs)
        for i, v in zip(grad, g):
            args[i] = v
        out = fn(*args, **attrs)
        return out if isinstance(out, tuple) else (out,)

    outs, vjp = jax.vjp(f, *[xs[i] for i in grad])
    hs = heads or _heads(outs)
    gs = vjp(tuple(jax.numpy.asarray(h) for h in hs)) if grad else ()
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in gs]


def port(name, inputs, attrs, grad, heads=None):
    """The same from the port's op under torch autograd."""
    xs = [torch.tensor(x) for x in inputs]
    for i in grad:
        xs[i].requires_grad_(True)
    out = treg.get_op(name).fn(*xs, **attrs)
    outs = out if isinstance(out, tuple) else (out,)
    hs = heads or _heads(outs)
    gs = torch.autograd.grad(outs, [xs[i] for i in grad],
                             [torch.tensor(h) for h in hs]) if grad else ()
    return ([o.detach().numpy() for o in outs],
            [g.numpy() for g in gs])


def check(name, inputs, attrs=None, grad=(0,)):
    attrs = attrs or {}
    jo, jg = reference(name, inputs, attrs, grad)
    to, tg = port(name, inputs, attrs, grad)
    assert len(to) == len(jo), (len(to), len(jo))
    for k, (t, j) in enumerate(zip(to + tg, jo + jg)):
        err = error_units(t, j, False, RTOL, ATOL)
        assert err <= 1.0, (name, attrs, k, err)
    return to, tg


# ---------------------------------------------------------------------------
# Deconvolution
# ---------------------------------------------------------------------------

DECONV = {
    "1d_stride_pad_adj": ((2, 3, 5), (3, 2, 3), dict(
        kernel=(3,), stride=(2,), pad=(1,), adj=(1,), num_filter=2)),
    "1d_dilation_target_shape": ((2, 3, 5), (3, 4, 3), dict(
        kernel=(3,), stride=(3,), dilate=(2,), num_filter=4,
        target_shape=(17,))),
    "1d_adj_past_the_stride": ((2, 2, 4), (2, 3, 3), dict(
        kernel=(3,), stride=(2,), pad=(2,), adj=(4,), num_filter=3)),
    "2d_groups_bias": ((2, 4, 3, 4), (4, 3, 3, 2), dict(
        kernel=(3, 2), stride=(2, 1), pad=(1, 0), adj=(1, 0), dilate=(1, 2),
        num_filter=6, num_group=2, no_bias=False)),
    "2d_dcgan_block": ((2, 8, 4, 4), (8, 4, 4, 4), dict(
        kernel=(4, 4), stride=(2, 2), pad=(1, 1), num_filter=4)),
    "2d_target_shape": ((1, 2, 3, 3), (2, 3, 3, 3), dict(
        kernel=(3, 3), stride=(2, 2), pad=(1, 1), num_filter=3,
        target_shape=(6, 5))),
    "3d_stride_adj": ((1, 2, 2, 3, 2), (2, 2, 2, 2, 2), dict(
        kernel=(2, 2, 2), stride=(2, 1, 2), adj=(1, 0, 1), num_filter=2)),
    "3d_groups_pad": ((1, 4, 3, 3, 3), (4, 1, 3, 3, 3), dict(
        kernel=(3, 3, 3), pad=(1, 1, 1), num_filter=2, num_group=2,
        no_bias=False)),
}


@pytest.mark.parametrize("case", sorted(DECONV))
def test_deconvolution(case):
    dshape, wshape, attrs = DECONV[case]
    inputs = [_a(*dshape), _a(*wshape, seed=1)]
    if not attrs.get("no_bias", True):
        inputs.append(_a(attrs["num_filter"], seed=2))
    out, _ = check("Deconvolution", inputs, attrs,
                   grad=tuple(range(len(inputs))))
    if attrs.get("target_shape"):
        assert out[0].shape[2:] == tuple(attrs["target_shape"])


# ---------------------------------------------------------------------------
# the norms, the activations, the resizes and the rest
# ---------------------------------------------------------------------------

OPS = {
    "LayerNorm": ([_a(3, 4, 5, lo=-2, hi=3), _a(5, lo=0.5, hi=1.5),
                   _a(5, seed=1)], {}, (0, 1, 2)),
    "LayerNorm_axis0_outputs": ([_a(3, 4, 5, lo=-2, hi=3), _a(3), _a(
        3, seed=1)], dict(axis=0, output_mean_var=True), (0, 1, 2)),
    "InstanceNorm": ([_a(2, 3, 4, 5, lo=-2, hi=3), _a(3, lo=0.5, hi=1.5),
                      _a(3, seed=1)], dict(eps=1e-5), (0, 1, 2)),
    "L2Normalization": ([_a(2, 3, 4)], dict(mode="channel"), (0,)),
    "LRN": ([_a(2, 5, 3, 3)], dict(nsize=3, alpha=0.2), (0,)),
    "LeakyReLU": ([_away(3, 4)], dict(slope=0.3), (0,)),
    "LeakyReLU_elu": ([_away(3, 4)], dict(act_type="elu", slope=0.5), (0,)),
    "LeakyReLU_gelu": ([_away(3, 4)], dict(act_type="gelu"), (0,)),
    "LeakyReLU_selu": ([_away(3, 4)], dict(act_type="selu"), (0,)),
    "LeakyReLU_prelu": ([_away(2, 3, 4), _a(3, seed=1)],
                        dict(act_type="prelu"), (0, 1)),
    "LeakyReLU_rrelu": ([_away(3, 4)], dict(act_type="rrelu",
                                            lower_bound=0.1,
                                            upper_bound=0.5), (0,)),
    "SoftmaxActivation": ([_a(2, 3, 4)], dict(mode="channel"), (0,)),
    "UpSampling": ([_a(2, 3, 3, 4)], dict(scale=2), (0,)),
    "UpSampling_bilinear": ([_a(2, 3, 3, 4)], dict(
        scale=2, sample_type="bilinear"), (0,)),
    "_contrib_BilinearResize2D_grow": ([_a(2, 3, 4, 5)], dict(
        height=9, width=7), (0,)),
    "_contrib_BilinearResize2D_shrink": ([_a(2, 3, 8, 9)], dict(
        height=3, width=4), (0,)),
    "_contrib_BilinearResize2D_scale": ([_a(1, 2, 6, 5)], dict(
        scale_height=0.5, scale_width=1.6), (0,)),
    "_contrib_AdaptiveAvgPooling2D_blocks": ([_a(2, 3, 6, 4)], dict(
        output_size=(2, 2)), (0,)),
    "_contrib_AdaptiveAvgPooling2D_resize": ([_a(2, 3, 7, 5)], dict(
        output_size=(3, 2)), (0,)),
    "SequenceMask": ([_a(4, 3, 2), _f([2, 4, 1])], dict(
        use_sequence_length=True, value=-2.0), (0,)),
    "SequenceMask_axis1": ([_a(3, 4, 2), _f([2, 4, 1])], dict(
        use_sequence_length=True, axis=1), (0,)),
    "SequenceLast": ([_a(4, 3, 2), _f([0, 9, 3])], dict(
        use_sequence_length=True), (0,)),
    "SequenceLast_axis1": ([_a(3, 4, 2), _f([2, 4, 1])], dict(
        use_sequence_length=True, axis=1), (0,)),
    "SequenceReverse": ([_a(4, 3, 2), _f([2, 4, 1])], dict(
        use_sequence_length=True), (0,)),
    "_contrib_div_sqrt_dim": ([_a(2, 3, 8)], {}, (0,)),
    "_contrib_quadratic": ([_a(3, 4)], dict(a=1.5, b=-0.5, c=0.25), (0,)),
    "IdentityAttachKLSparseReg": ([_a(3, 4)], dict(penalty=0.1), (0,)),
}


def check_case(case):
    """``OPS[case]``, the op named by the case's longest matching
    prefix (run by ``test_torch_nn_ops_b.py``)."""
    inputs, attrs, grad = OPS[case]
    name = next(n for n in sorted(treg.list_ops(), key=len, reverse=True)
                if case == n or case.startswith(n + "_"))
    check(name, inputs, attrs, grad)


# ---------------------------------------------------------------------------
# the heads: their own gradients, whatever the head gradient
# ---------------------------------------------------------------------------

HEADS = {
    "LinearRegressionOutput": ([_a(3, 4), _a(3, 4, seed=1)],
                               dict(grad_scale=2.0)),
    "MAERegressionOutput": ([_a(3, 4), _a(3, 4, seed=1)], {}),
    "LogisticRegressionOutput": ([_a(3, 4), _a(3, 4, lo=0, hi=1, seed=1)],
                                 dict(grad_scale=0.5)),
    "SVMOutput": ([_a(4, 5, lo=-2, hi=2), _f([0, 3, 1, 9])], dict(
        margin=0.7, regularization_coefficient=1.5)),
    "SVMOutput_linear": ([_a(4, 5, lo=-2, hi=2), _f([0, 3, 1, -1])], dict(
        use_linear=True)),
    "MakeLoss": ([_a(3, 4)], dict(grad_scale=3.0)),
    "MakeLoss_batch": ([_a(3, 4)], dict(normalization="batch")),
}


@pytest.mark.parametrize("case", sorted(HEADS))
def test_a_head_ignores_the_head_gradient(case):
    name = case.split("_linear")[0].split("_batch")[0]
    inputs, attrs = HEADS[case]
    out, grads = check(name, inputs, attrs)
    other = [np.full_like(out[0], 5.0)]
    assert np.array_equal(port(name, inputs, attrs, (0,), other)[1][0],
                          grads[0])
    assert np.array_equal(reference(name, inputs, attrs, (0,), other)[1][0],
                          reference(name, inputs, attrs, (0,))[1][0])


def test_regression_gradient_is_the_scaled_difference():
    x, y = _a(3, 4), _a(3, 4, seed=1)
    g = port("LinearRegressionOutput", [x, y], dict(grad_scale=2.0),
             (0,))[1][0]
    np.testing.assert_allclose(g, (x - y) * 2.0 / 4, rtol=1e-6)


# ---------------------------------------------------------------------------
# the symbolic side: names and shapes the ops infer
# ---------------------------------------------------------------------------

def _graphs(mx):
    s = mx.sym
    data = s.var("data")
    return {
        "deconv": (s.Deconvolution(data, kernel=(4, 4), stride=(2, 2),
                                   pad=(1, 1), num_filter=6, num_group=2,
                                   no_bias=False, name="up"),
                   (2, 4, 5, 5)),
        "deconv_no_bias": (s.Deconvolution(data, kernel=(3,),
                                           num_filter=3, name="up"),
                           (2, 4, 7)),
        "layernorm": (s.LayerNorm(data, axis=1, name="ln"), (2, 4, 5)),
        "instancenorm": (s.InstanceNorm(data, name="inorm"), (2, 3, 4, 4)),
        "prelu": (s.LeakyReLU(data, act_type="prelu", name="act"),
                  (2, 3, 4)),
        "leaky": (s.LeakyReLU(data, slope=0.2, name="act"), (2, 3)),
        "heads": (s.Group([
            s.LinearRegressionOutput(data, name="lin"),
            s.MAERegressionOutput(data, name="mae"),
            s.LogisticRegressionOutput(data, name="logit"),
            s.SVMOutput(data, name="svm")]), (4, 5)),
    }


@pytest.mark.parametrize("graph", sorted(_graphs(tmx)))
def test_infer_shape_matches_the_reference(graph):
    res = []
    for mx in (jmx, tmx):
        with mx.sym.NameManager():
            sym, shape = _graphs(mx)[graph]
        res.append((sym.list_arguments(), sym.infer_shape_partial(
            data=shape)))
    (jnames, jshapes), (tnames, tshapes) = res
    assert tnames == jnames
    assert [list(x) for x in tshapes] == [list(x) for x in jshapes]
