"""The PyTorch port's INT8 ops (`mxtpu_torch/ops/quantization.py`)
against the JAX package's (`mxtpu/ops/quantization.py`) on the same
numpy inputs on the CPU.

Every integer output (the int8 data, the int32 accumulators) must be
equal, and every float output (ranges, dequantized values) within the
op sweep's bound (`test_torch_ops.close`: 1e-5 relative plus 1e-6 of
the largest magnitude): the packages do the same float32 operations in
the same order, but XLA may fuse a product and a sum into one
rounding.  The products cover K = 27 and K = 147 (neither a multiple
of 8), a grouped, strided and dilated convolution, a 1x1 convolution
and the bias rescaled from its own range; the average pool's cast
truncates in both.  The card's route (`int8_matmul`, `int8_conv`: zero
padding to `torch._int_mm`'s shape rules, the int8 im2col, a product a
group) runs here on the CPU's `_int_mm` and must equal the float64
plain version exactly, at ResNet-50's shapes cut in batch and side.
The composers' input names and the inferred output types are
`mxtpu`'s.
"""
import numpy as np
import pytest
import torch

import mxtpu as jmx
import mxtpu_torch as tmx
from mxtpu_torch.ops import quantization as tq
from test_torch_ops import close

torch.set_num_threads(1)


def _i8(*shape, seed=0):
    return np.random.RandomState(seed).randint(-127, 128, shape) \
        .astype(np.int8)


def _r(v):
    return np.asarray([v], np.float32)


def both(op, *inputs, **attrs):
    """``nd.<op>`` of both packages on the CPU: (JAX's outputs, the
    port's), as lists of numpy arrays."""
    outs = []
    for M in (jmx, tmx):
        xs = [M.nd.array(x, ctx=M.cpu(), dtype=x.dtype) for x in inputs]
        res = getattr(M.nd, op)(*xs, **attrs)
        outs.append([o.asnumpy() for o in
                     (res if isinstance(res, list) else [res])])
    return outs


def same(op, *inputs, **attrs):
    want, got = both(op, *inputs, **attrs)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, (g.dtype, w.dtype,
                                                           g.shape, w.shape)
        close(g, w, op, exact=not np.issubdtype(w.dtype, np.floating))
    return got


@pytest.mark.parametrize("out_type", ["int8", "uint8"])
def test_quantize_and_dequantize_round_trip(out_type):
    x = np.random.RandomState(0).uniform(-2, 3, (6, 7)).astype(np.float32)
    q, lo, hi = same("_contrib_quantize_v2", x, out_type=out_type)
    assert lo.shape == () and hi.shape == ()
    same("_contrib_quantize", x, _r(-1.5), _r(2.5), out_type=out_type)
    same("_contrib_quantize_v2", x, out_type=out_type,
         min_calib_range=-1.0, max_calib_range=1.2)
    back, = same("_contrib_dequantize", q, lo.reshape(1), hi.reshape(1))
    step = (3.0 if out_type == "int8" else 5.0) / (127 if out_type == "int8"
                                                   else 255)
    assert np.abs(back - x).max() <= step


def test_quantize_rounds_half_to_even():
    # 0.5 / 1 * 127 = 63.5 and 1.5 / ... on a range whose max is 127
    x = np.asarray([63.5, 64.5, -63.5, 127.0, 0.5], np.float32)
    q, _, _ = same("_contrib_quantize_v2", x)
    np.testing.assert_array_equal(q, [64, 64, -64, 127, 0])


def test_requantize_and_int32_dequantize():
    acc = np.random.RandomState(1).randint(-2 ** 30, 2 ** 30, (5, 6)) \
        .astype(np.int32)
    same("_contrib_requantize", acc, _r(-40.0), _r(40.0))
    same("_contrib_requantize", acc, _r(-40.0), _r(40.0),
         min_calib_range=-9.0, max_calib_range=11.0)
    same("_contrib_dequantize", acc, _r(-40.0), _r(40.0))


@pytest.mark.parametrize("bias_range", [False, True])
def test_quantized_fully_connected_is_exact(bias_range):
    x, w, b = _i8(20, 3, 9), _i8(10, 27, seed=1), _i8(10, seed=2)
    ranges = [_r(-0.8), _r(1.3), _r(-0.4), _r(0.2)]
    if bias_range:
        ranges += [_r(-0.1), _r(0.3)]
    acc, lo, hi = same("_contrib_quantized_fully_connected", x, w, b,
                       *ranges, num_hidden=10)
    assert acc.dtype == np.int32
    plain = x.reshape(20, -1).astype(np.int64) @ w.astype(np.int64).T
    if not bias_range:
        np.testing.assert_array_equal(acc, plain + b)


CONVS = [  # (data, weight, attrs)
    ((2, 3, 6, 6), (4, 3, 3, 3), dict(kernel=(3, 3), pad=(1, 1))),
    ((1, 3, 12, 12), (5, 3, 7, 7), dict(kernel=(7, 7), stride=(2, 2),
                                        pad=(3, 3))),
    ((2, 4, 9, 9), (6, 2, 3, 3), dict(kernel=(3, 3), stride=(2, 2),
                                      dilate=(2, 2), pad=(2, 2),
                                      num_group=2)),
    ((2, 8, 5, 5), (16, 8, 1, 1), dict(kernel=(1, 1))),
    ((2, 8, 6, 6), (16, 8, 1, 1), dict(kernel=(1, 1), stride=(2, 2))),
]


@pytest.mark.parametrize("k", range(len(CONVS)))
def test_quantized_conv_is_exact(k):
    dshape, wshape, attrs = CONVS[k]
    x, w, b = _i8(*dshape, seed=k), _i8(*wshape, seed=10 + k), \
        _i8(wshape[0], seed=20 + k)
    acc, _, _ = same("_contrib_quantized_conv", x, w, b, _r(-1.0), _r(1.0),
                     _r(-0.3), _r(0.5), _r(-0.1), _r(0.1),
                     num_filter=wshape[0], **attrs)
    # the accumulator before the bias, against float64
    acc0, _, _ = same("_contrib_quantized_conv", x, w, b, _r(-1.0),
                      _r(1.0), _r(-0.3), _r(0.5), num_filter=wshape[0],
                      no_bias=True, **attrs)
    ref = torch.nn.functional.conv2d(
        torch.from_numpy(x).double(), torch.from_numpy(w).double(),
        stride=attrs.get("stride", 1), padding=attrs.get("pad", 0),
        dilation=attrs.get("dilate", 1), groups=attrs.get("num_group", 1))
    np.testing.assert_array_equal(acc0, ref.numpy().astype(np.int32))


def test_quantized_pooling_flatten_concat():
    x = _i8(2, 3, 7, 7)
    same("_contrib_quantized_pooling", x, _r(-1.0), _r(1.0), kernel=(2, 2),
         stride=(2, 2), pool_type="max")
    out, _, _ = same("_contrib_quantized_pooling", x, _r(-1.0), _r(1.0),
                     kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                     pool_type="avg")
    mean = torch.nn.functional.avg_pool2d(torch.from_numpy(x).float(), 3, 2,
                                          1).numpy()
    np.testing.assert_array_equal(out, np.trunc(mean).astype(np.int8))
    assert (mean < 0).any() and (mean != np.trunc(mean)).any()
    same("_contrib_quantized_flatten", x, _r(-1.0), _r(1.0))
    same("_contrib_quantized_concat", x, _i8(2, 2, 7, 7, seed=1), _r(-0.5),
         _r(-2.0), _r(0.7), _r(0.4), dim=1, num_args=2)


# ResNet-50 v1's convolution shapes at batch 2 and a quarter of the side
# (the card's check holds the full size): (C, O, kernel, stride, pad, side)
RESNET_CONVS = [(3, 64, 7, 2, 3, 56), (64, 64, 1, 1, 0, 14),
                (64, 64, 3, 1, 1, 14), (64, 256, 1, 1, 0, 14),
                (256, 128, 1, 1, 0, 14), (128, 128, 3, 2, 1, 14),
                (512, 1024, 1, 2, 0, 8), (512, 512, 3, 1, 1, 4)]


@pytest.mark.parametrize("shape", RESNET_CONVS)
def test_the_cards_route_equals_the_plain_version(shape):
    c, o, k, s, p, side = shape
    x = torch.from_numpy(_i8(2, c, side, side))
    w = torch.from_numpy(_i8(o, c, k, k, seed=1))
    before = tq.INT8_LAUNCHES["int8_gemm"]
    got = tq.int8_conv(x, w, (s, s), (1, 1), (p, p))
    assert tq.INT8_LAUNCHES["int8_gemm"] == before + 1
    want = tq.plain_conv(x, w, (s, s), (1, 1), (p, p))
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert torch.equal(got, want)


def test_the_cards_route_pads_to_int_mm_shapes():
    # m < 17, k and n not multiples of 8; groups one product each
    for m, k, n in ((5, 27, 7), (17, 147, 64), (3, 8, 1000)):
        a = torch.from_numpy(_i8(m, k))
        b = torch.from_numpy(_i8(k, n, seed=1))
        assert torch.equal(tq.int8_matmul(a, b), tq.plain_matmul(a, b))
    x, w = torch.from_numpy(_i8(2, 6, 5, 5)), torch.from_numpy(
        _i8(9, 2, 3, 3, seed=2))
    before = tq.INT8_LAUNCHES["int8_gemm"]
    assert torch.equal(tq.int8_conv(x, w, (1, 1), (2, 2), (2, 2), groups=3),
                       tq.plain_conv(x, w, (1, 1), (2, 2), (2, 2), groups=3))
    assert tq.INT8_LAUNCHES["int8_gemm"] == before + 3


def test_symbol_inputs_and_output_types_match():
    """The composers' auto-created inputs, and the int32 and float32
    outputs inferred through meta tensors, are `mxtpu`'s."""
    got = []
    for M in (jmx, tmx):
        s = M.sym

        def var(name, shape, dtype=np.float32):
            return s.Variable(name, shape=shape, dtype=dtype)

        q = s.contrib.quantize_v2(var("data", (2, 3, 6, 6)), name="q")
        auto = s.contrib.quantized_conv(q[0], min_data=q[1], max_data=q[2],
                                        kernel=(3, 3), num_filter=4,
                                        name="qa")
        conv = s.contrib.quantized_conv(
            q[0], var("w", (4, 3, 3, 3), np.int8), var("b", (4,), np.int8),
            q[1], q[2], var("wmin", (1,)), var("wmax", (1,)),
            kernel=(3, 3), num_filter=4, name="qc")
        flat = s.contrib.quantized_flatten(conv[0], conv[1], conv[2])
        fc = s.contrib.quantized_fully_connected(
            flat[0], var("fw", (5, 64), np.int8), var("fb", (5,), np.int8),
            flat[1], flat[2], var("fwmin", (1,)), var("fwmax", (1,)),
            num_hidden=5, name="qf")
        out = s.Group([conv[0], conv[1], fc[0],
                       s.contrib.dequantize(fc[0], fc[1], fc[2])])
        _, out_shapes, _ = out.infer_shape()
        _, out_types, _ = out.infer_type()
        got.append((auto.list_arguments(), [tuple(x) for x in out_shapes],
                    [np.dtype(t) for t in out_types]))
    assert got[1] == got[0]
    assert got[1][0][1:] == ["qa_weight", "qa_bias", "qa_min_weight",
                             "qa_max_weight"]
    assert got[1][2] == [np.int32, np.float32, np.int32, np.float32]
