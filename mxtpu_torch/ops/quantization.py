"""INT8 quantization ops of the PyTorch port (counterpart of
``mxtpu/ops/quantization.py``): ``_contrib_quantize``,
``_contrib_quantize_v2``, ``_contrib_dequantize``,
``_contrib_requantize``, ``_contrib_quantized_fully_connected``,
``_contrib_quantized_conv``, ``_contrib_quantized_pooling``,
``_contrib_quantized_flatten`` and ``_contrib_quantized_concat``.
Calibration and the graph rewrite live in
``mxtpu_torch.contrib.quantization``.

* int8 is symmetric (scale 127 / max(|min|, |max|), zero point 0) and
  uint8 affine, as in the JAX package, with its order of operations in
  float32: ``data / t * 127``, then the clip, then the cast; ``round``
  is half to even in both packages.  A division by a constant divides
  by a tensor on the data's device: on the card torch multiplies by the
  reciprocal of a host scalar instead, which can move a value by one
  ulp and a quantized value by one step.  ``_contrib_dequantize``'s
  ``(q - qmin) * scale + min`` rounds once, as XLA's fused multiply-add
  does: an int32 accumulator shifted by 2^31 keeps only its high bits in
  float32, and a second rounding would move the result by up to 1%.
* The int8 products accumulate int8 x int8 in int32 and must equal the
  exact sum.  On the card they run on ``torch._int_mm`` (cuBLASLt's
  int8 GEMM): the fully connected layer directly, the convolution as
  an int8 im2col (strided views of the padded input, copied
  contiguous; a 1x1 convolution at stride 1 is a reshape) and one
  product a group.  ``_int_mm`` takes m > 16 and k and n multiples of
  8, so the operands are padded with zeros, which leave integer sums
  unchanged (a first convolution's K = 3 x 7 x 7 = 147 among them).
  ``INT8_LAUNCHES`` counts those products.  On the CPU (and on
  ``meta`` tensors) the same product runs in float64, the plain
  version: it is exact, since |acc| <= 127^2 K < 2^53.  A CUDA tensor
  never takes the plain version.
* The quantized pooling casts its float32 pool back to the input's
  integer type, which truncates, as the JAX package's ``astype`` does.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .registry import register

__all__ = ["INT8_LAUNCHES", "int8_matmul", "int8_conv", "plain_matmul",
           "plain_conv"]

# products that ran on the card's int8 route (``torch._int_mm``)
INT8_LAUNCHES = {"int8_gemm": 0}

_INT32_SPAN = 2.0 ** 31 - 1


def _div(a, b):
    """``a / b`` with ``b`` a tensor on ``a``'s device: true division
    on every device (see the module's docstring)."""
    return a / torch.as_tensor(b, dtype=a.dtype, device=a.device)


def _as_f32(x, like):
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def _quant_range(out_type="int8"):
    if out_type == "uint8":
        return 0.0, 255.0
    return -127.0, 127.0


def _quantize_core(data, lo, hi, out_type):
    if out_type == "uint8":
        scale = _div(torch.full_like(hi - lo, 255.0),
                     torch.clamp(hi - lo, min=1e-12))
        q = torch.clamp(torch.round((data - lo) * scale), 0.0, 255.0)
        return q.to(torch.uint8), lo, hi
    t = torch.clamp(torch.maximum(lo.abs(), hi.abs()), min=1e-12)
    q = torch.clamp(torch.round(data / t * 127.0), -127, 127)
    t32 = t.to(torch.float32)
    return q.to(torch.int8), -t32, t32


@register("_contrib_quantize", num_outputs=3, differentiable=False)
def _quantize(data, min_range, max_range, out_type="int8"):
    return _quantize_core(data, min_range, max_range, out_type)


@register("_contrib_quantize_v2", num_outputs=3, differentiable=False)
def _quantize_v2(data, out_type="int8", min_calib_range=None,
                 max_calib_range=None):
    if min_calib_range is None:
        lo, hi = data.min(), data.max()
    else:
        lo = torch.as_tensor(min_calib_range, dtype=data.dtype,
                             device=data.device)
        hi = torch.as_tensor(max_calib_range, dtype=data.dtype,
                             device=data.device)
    return _quantize_core(data, lo, hi, out_type)


@register("_contrib_dequantize", differentiable=False)
def _dequantize(data, min_range, max_range, out_type="float32"):
    if data.dtype == torch.uint8:
        qmin, qmax = 0.0, 255.0
    elif data.dtype == torch.int32:
        # int8 x int8 accumulators carry the +-(2^31 - 1) span
        # (_int32_out_range); dequantize uses the same one
        qmin, qmax = -_INT32_SPAN, _INT32_SPAN
    else:
        qmin, qmax = -127.0, 127.0
    scale = _div(max_range - min_range, qmax - qmin)
    # XLA fuses the product and the sum into one FMA (one rounding);
    # the float64 product of two float32 values is exact, so the sum
    # in float64 rounded once to float32 gives the FMA's value on any
    # device, where two float32 roundings lose the bits that cancel
    shifted = data.to(torch.float32) - qmin
    return (shifted.double() * scale.double() + min_range.double()) \
        .to(torch.float32)


@register("_contrib_requantize", num_outputs=3, differentiable=False)
def _requantize(data, min_range, max_range, out_type="int8",
                min_calib_range=None, max_calib_range=None):
    real = data.to(torch.float32) * _div(
        torch.maximum(min_range.abs(), max_range.abs()), _INT32_SPAN)
    if min_calib_range is not None:
        lo = _as_f32(min_calib_range, data)
        hi = _as_f32(max_calib_range, data)
    else:
        lo, hi = real.min(), real.max()
    scale = _div(torch.full_like(lo, 127.0),
                 torch.clamp(torch.maximum(lo.abs(), hi.abs()), min=1e-12))
    q = torch.clamp(torch.round(real * scale), -127, 127).to(torch.int8)
    return q, lo.to(torch.float32), hi.to(torch.float32)


def _int32_out_range(min_data, max_data, min_weight, max_weight):
    """The int32 range of an int8 x int8 accumulator: real = acc * sd *
    sw, so the range is +-(2^31 - 1) sd sw."""
    sd = _div(torch.maximum(min_data.abs(), max_data.abs()), 127.0)
    sw = _div(torch.maximum(min_weight.abs(), max_weight.abs()), 127.0)
    hi = (sd * sw * _INT32_SPAN).to(torch.float32)
    return -hi, hi


def _rescaled_bias(bias, min_data, max_data, min_weight, max_weight,
                   min_bias, max_bias):
    """The bias, quantized at its own scale sb, in the accumulator's
    sd sw units: round(bias sb / (sd sw))."""
    if min_bias is None or max_bias is None:
        return bias.to(torch.int32)
    sd = _div(torch.maximum(min_data.abs(), max_data.abs()), 127.0)
    sw = _div(torch.maximum(min_weight.abs(), max_weight.abs()), 127.0)
    sb = _div(torch.maximum(min_bias.abs(), max_bias.abs()), 127.0)
    scale = sb / (sd * sw)
    return torch.round(bias.to(torch.float32) * scale).to(torch.int32)


# ---------------------------------------------------------------------------
# the int8 products: _int_mm on the card, float64 elsewhere
# ---------------------------------------------------------------------------

def _round_up(n, m):
    return -(-n // m) * m


def plain_matmul(a, b):
    """The exact int32 product of int8 ``a`` (m, k) and ``b`` (k, n) in
    float64: the plain version."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)) \
        .to(torch.int32)


def int8_matmul(a, b):
    """``a`` (m, k) x ``b`` (k, n), int8, accumulated in int32 on the
    card by ``torch._int_mm``, the operands zero-padded to its shape
    rules (m > 16, k and n multiples of 8)."""
    m, k = a.shape
    n = b.shape[1]
    mp, kp, np_ = max(m, 17), _round_up(max(k, 8), 8), _round_up(max(n, 8), 8)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        b = F.pad(b, (0, np_ - n, 0, kp - k))
    INT8_LAUNCHES["int8_gemm"] += 1
    out = torch._int_mm(a.contiguous(), b.contiguous())
    return out[:m, :n]


def _matmul(a, b):
    if a.is_cuda:
        return int8_matmul(a, b)
    return plain_matmul(a, b)


def _columns(x, kernel, stride, dilate, pad):
    """im2col of ``x`` (N, C, *spatial): (N * prod(out), C * prod(kernel))
    in (c, taps) order, from strided views of the zero-padded input."""
    ns = len(kernel)
    if any(pad):
        x = F.pad(x, [p for q in reversed(pad) for p in (q, q)])
    n, c = x.shape[:2]
    sp = x.shape[2:]
    out = [(sp[i] - dilate[i] * (kernel[i] - 1) - 1) // stride[i] + 1
           for i in range(ns)]
    if all(k == 1 for k in kernel) and all(s == 1 for s in stride):
        cols = x.movedim(1, -1)
        return cols.reshape(-1, c), out
    st = x.stride()
    view = x.as_strided(
        (n, c) + tuple(out) + tuple(kernel),
        (st[0], st[1]) + tuple(st[2 + i] * stride[i] for i in range(ns))
        + tuple(st[2 + i] * dilate[i] for i in range(ns)))
    # (N, *out, C, *kernel)
    perm = (0,) + tuple(range(2, 2 + ns)) + (1,) + tuple(
        range(2 + ns, 2 + 2 * ns))
    cols = view.permute(perm).reshape(-1, c * math.prod(kernel))
    return cols, out


def _conv_int32(x, w, stride, dilate, pad, groups, matmul):
    ns = w.dim() - 2
    kernel = tuple(w.shape[2:])
    n = x.shape[0]
    cg = x.shape[1] // groups
    og = w.shape[0] // groups
    accs = []
    for g in range(groups):
        xg = x[:, g * cg:(g + 1) * cg] if groups > 1 else x
        wg = w[g * og:(g + 1) * og] if groups > 1 else w
        cols, out = _columns(xg, kernel, stride, dilate, pad)
        accs.append(matmul(cols, wg.reshape(og, -1).t()))
    acc = torch.cat(accs, dim=1) if groups > 1 else accs[0]
    return acc.reshape((n,) + tuple(out) + (w.shape[0],)).movedim(-1, 1)


def plain_conv(x, w, stride, dilate, pad, groups=1):
    """The exact int32 convolution of int8 ``x`` and ``w`` through the
    float64 im2col product: the plain version."""
    return _conv_int32(x, w, stride, dilate, pad, groups, plain_matmul)


def int8_conv(x, w, stride, dilate, pad, groups=1):
    """The int8 convolution on the card: im2col and ``int8_matmul``."""
    return _conv_int32(x, w, stride, dilate, pad, groups, int8_matmul)


def _conv(x, w, stride, dilate, pad, groups):
    if x.is_cuda:
        return int8_conv(x, w, stride, dilate, pad, groups)
    return plain_conv(x, w, stride, dilate, pad, groups)


def _norm(v, n, default):
    if not v:
        return (default,) * n
    v = tuple(int(e) for e in v)
    return v * n if len(v) == 1 else v


@register("_contrib_quantized_fully_connected", num_outputs=3,
          differentiable=False)
def _quantized_fc(data, weight, bias, min_data, max_data, min_weight,
                  max_weight, min_bias=None, max_bias=None, num_hidden=0,
                  no_bias=False, flatten=True):
    x = data.reshape(data.shape[0], -1) if flatten else data
    lead = x.shape[:-1]
    acc = _matmul(x.to(torch.int8).reshape(-1, x.shape[-1]),
                  weight.to(torch.int8).t()).reshape(lead + (-1,))
    if not no_bias and bias is not None:
        acc = acc + _rescaled_bias(bias, min_data, max_data, min_weight,
                                   max_weight, min_bias, max_bias)
    out_min, out_max = _int32_out_range(min_data, max_data, min_weight,
                                        max_weight)
    return acc, out_min, out_max


@register("_contrib_quantized_conv", num_outputs=3, differentiable=False)
def _quantized_conv(data, weight, bias, min_data, max_data, min_weight,
                    max_weight, min_bias=None, max_bias=None, kernel=(),
                    stride=(), dilate=(), pad=(), num_filter=0, num_group=1,
                    no_bias=False, workspace=1024, layout=None,
                    cudnn_tune=None, cudnn_off=False):
    ns = len(kernel)
    acc = _conv(data.to(torch.int8), weight.to(torch.int8),
               _norm(stride, ns, 1), _norm(dilate, ns, 1), _norm(pad, ns, 0),
               int(num_group))
    if not no_bias and bias is not None:
        acc = acc + _rescaled_bias(bias, min_data, max_data, min_weight,
                                   max_weight, min_bias, max_bias
                                   ).reshape((1, -1) + (1,) * ns)
    out_min, out_max = _int32_out_range(min_data, max_data, min_weight,
                                        max_weight)
    return acc, out_min, out_max


@register("_contrib_quantized_pooling", num_outputs=3, differentiable=False)
def _quantized_pooling(data, min_data, max_data, **attrs):
    from .nn import _pooling

    out = _pooling(data.to(torch.float32), **attrs)
    return out.to(data.dtype), min_data, max_data


@register("_contrib_quantized_flatten", num_outputs=3, differentiable=False)
def _quantized_flatten(data, min_data, max_data):
    return data.reshape(data.shape[0], -1), min_data, max_data


@register("_contrib_quantized_concat", num_outputs=3, differentiable=False)
def _quantized_concat(*args, dim=1, num_args=None):
    n = len(args) // 3
    datas, mins, maxs = args[:n], args[n:2 * n], args[2 * n:]
    out = torch.cat(datas, dim=dim)
    return out, torch.stack(mins).min(), torch.stack(maxs).max()
