"""Neural-network ops of the PyTorch port.

Counterpart of ``mxtpu/ops/nn.py``, every name of it: ``FullyConnected``,
``Convolution``, ``Deconvolution``, ``Pooling``, the resizes
(``UpSampling``, ``_contrib_BilinearResize2D``,
``_contrib_AdaptiveAvgPooling2D``), the norms (``BatchNorm``,
``LayerNorm``, ``InstanceNorm``, ``L2Normalization``, ``LRN``), the
activations (``Activation``, ``LeakyReLU`` and its modes, ``relu``,
``sigmoid``, ``hard_sigmoid``, ``softsign``, ``SoftmaxActivation``),
the softmax family, ``Dropout``, the output heads with their own
gradients (``SoftmaxOutput``, the three regression outputs,
``SVMOutput``, ``MakeLoss``), ``CTCLoss``, the Sequence ops and the
small contrib ops, with the reference's names, attrs and NCHW/OIHW
layouts, and the channels-last ``layout`` (NWC, NHWC, NDHWC) of
Convolution and Pooling.  Convolution, Deconvolution
and the products are torch's calls (cuDNN and cuBLAS on the card, float32
with TF32 off: ``registry.float32_numerics``), as the JAX package
leaves them to XLA; a bf16 or
fp16 convolution on the CPU runs in float32 and rounds once, as those
libraries accumulate.

* BatchNorm computes its training statistics in f32 (or f64 for f64
  data, which the JAX package never sees) as the JAX package's does, the
  batch mean and the biased variance, and returns
  (out, mean, var); the executor folds the moving stats from them.  It
  never hands the aux arrays to ``F.batch_norm``, whose running-stat
  update uses the unbiased variance and the opposite momentum.  The
  variance comes from ``torch.var_mean`` (one read, stable) rather than
  the JAX package's ``max(E[x^2] - E[x]^2, 0)``: the same function, but
  that form cancels where the mean is large against the spread (a conv
  of non-negative inputs at initialisation), and its rounding then
  moves a ResNet's early gradients by up to a few percent against
  float64, where ``var_mean``'s stay within 1e-4
  (``tests/test_torch_module.py`` measures both).
* SoftmaxOutput's gradient ignores the head gradient, as the
  reference's does: ``(softmax - onehot(label)) * grad_scale`` over the
  ``normalization``, zero for the label (``_SoftmaxOutput``); a label
  outside [0, n_class) has a zero one-hot row, as in the reference.
  So do the other heads (``_LossHead``).
* Dropout keeps each element (or each slice along ``axes``) with
  probability ``1 - p`` and scales the kept ones by ``1 / (1 - p)``,
  drawing from the device's generator; outside training (and ``mode``
  not ``always``) it is the identity.  The draws differ from the JAX
  package's; the distribution is the same.
* Pooling pads per ``_pool_pads`` (``valid``/``full``); torch's pooling
  takes only a symmetric pad of at most half the kernel, so any other
  pad is applied explicitly (-inf for max, zeros for avg/sum).
* Deconvolution is ``F.conv_transpose*d``; an ``adj`` (output padding)
  of at least ``max(stride, dilate)``, which torch refuses, is computed
  unpadded and cut or padded with zeros to the reference's size.
* The bilinear resizes antialias when they shrink, as
  ``jax.image.resize`` does (``F.interpolate(antialias=True)``).
* CTCLoss is ``F.ctc_loss`` on the log-softmax, with the reference's
  label lengths and padding conventions; a row ``F.ctc_loss`` cannot
  take as the reference reads it (a label it cannot emit in its time,
  one outside the classes or the blank inside the used labels) runs
  the reference's own recursion (``_ctc_recursion``), which gives such
  a row the finite cost of its ``log_epsilon`` (about 1e5) and its
  gradient.
"""
from __future__ import annotations

import functools
import os

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError, torch_dtype
from .matrix import clip_tensor
from .registry import register

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}
_SPATIAL = {1: "W", 2: "HW", 3: "DHW"}
_LOWP = (torch.bfloat16, torch.float16)


def _norm_tuple(v, n, default):
    if not v:
        return (default,) * n
    if isinstance(v, int):
        return (v,) * n
    return tuple(v)


_CL_FORMAT = {2: torch.channels_last, 3: torch.channels_last_3d}


def _channels_last(layout, ns) -> bool:
    """True for ``N<spatial>C`` (NWC, NHWC, NDHWC), False for
    ``NC<spatial>`` or no layout; any other raises."""
    lay = str(layout or "").upper()
    if lay in ("", "NC" + _SPATIAL[ns]):
        return False
    if lay == "N" + _SPATIAL[ns] + "C":
        return True
    raise MXNetError("layout %r: NC%s or N%sC only"
                     % (layout, _SPATIAL[ns], _SPATIAL[ns]))


def _env_channels_last() -> bool:
    """``MXTPU_CONV_LAYOUT=NHWC``: an NCHW convolution runs on
    channels-last memory (same values, NCHW shapes)."""
    return os.environ.get("MXTPU_CONV_LAYOUT", "").upper() == "NHWC"


def _to_nc(x, ns):
    """An N<spatial>C tensor as NC<spatial>: for 2 and 3 spatial dims a
    permuted view, which is NCHW in torch's channels-last memory format;
    for one (no such format) a copy."""
    x = x.permute(0, ns + 1, *range(1, ns + 1))
    return x.contiguous() if ns == 1 else x


def _from_nc(x, ns):
    """The inverse of ``_to_nc``: a channels-last NC<spatial> result is
    a contiguous N<spatial>C tensor after the permute, with no copy."""
    x = x.permute(0, *range(2, ns + 2), 1)
    return x.contiguous() if ns == 1 else x


# ---------------------------------------------------------------------------
# FullyConnected
# ---------------------------------------------------------------------------

@register("FullyConnected", fp32_library=True)
def _fully_connected(data, weight, *maybe_bias, num_hidden=0, no_bias=False,
                     flatten=True):
    x = data.reshape(data.shape[0], -1) if flatten else data
    bias = maybe_bias[0] if maybe_bias and not no_bias else None
    if bias is not None and x.dtype in _LOWP:
        # the product rounds to the low precision before the bias is
        # added, as the JAX package's dot and add do
        return F.linear(x, weight) + bias
    return F.linear(x, weight, bias)


# ---------------------------------------------------------------------------
# Convolution (NCHW data, OIHW weight)
# ---------------------------------------------------------------------------

@register("Convolution", aliases=("Convolution_v1",),
          fp32_library=True)
def _convolution(data, weight, *maybe_bias, kernel=(), stride=(), dilate=(),
                 pad=(), num_filter=0, num_group=1, no_bias=False,
                 workspace=1024, layout=None, cudnn_tune=None,
                 cudnn_off=False):
    """``layout="NHWC"`` (NWC, NDHWC) takes and gives channels-last data
    with the OIHW weight, as the JAX package's does: the data is viewed
    as NCHW in channels-last memory and the weight put in that format,
    so the convolution runs on cuDNN's NHWC kernels and the result's
    permute back is NHWC with no copy."""
    ns = len(kernel)
    cl = _channels_last(layout, ns)
    x = _to_nc(data, ns) if cl else data
    w = weight
    fmt = _CL_FORMAT.get(ns)
    if fmt is not None and (cl or _env_channels_last()):
        x = x.contiguous(memory_format=fmt)
        w = w.contiguous(memory_format=fmt)
    bias = maybe_bias[0] if maybe_bias and not no_bias else None
    conv = functools.partial(_CONV[ns], stride=_norm_tuple(stride, ns, 1),
                             padding=_norm_tuple(pad, ns, 0),
                             dilation=_norm_tuple(dilate, ns, 1),
                             groups=num_group)
    if x.device.type == "cpu" and x.dtype in _LOWP:
        # products of low-precision inputs accumulate in float32 and
        # round once, as XLA's and cuDNN's do (torch's CPU kernel rounds
        # more); the bias is added after that rounding, as the JAX
        # package's add and torch's cuDNN path add it
        out = conv(x.float(), w.float()).to(x.dtype)
        if bias is not None:
            out = out + bias.view((1, -1) + (1,) * ns)
    else:
        out = conv(x, w, bias)
    return _from_nc(out, ns) if cl else out


_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


@register("Deconvolution", fp32_library=True)
def _deconvolution(data, weight, *maybe_bias, kernel=(), stride=(),
                   dilate=(), pad=(), adj=(), target_shape=(), num_filter=0,
                   num_group=1, no_bias=True, workspace=1024, layout=None,
                   cudnn_tune=None, cudnn_off=False):
    """The transposed convolution of ``data`` by ``weight`` (C_in,
    num_filter / num_group, *kernel).  ``target_shape`` sets ``adj`` as
    the reference computes it; ``layout`` is ignored, as there."""
    ns = len(kernel)
    stride = _norm_tuple(stride, ns, 1)
    dilate = _norm_tuple(dilate, ns, 1)
    pad = _norm_tuple(pad, ns, 0)
    adj = _norm_tuple(adj, ns, 0)
    if target_shape:
        adj = tuple((target_shape[i] + 2 * pad[i]
                     - ((kernel[i] - 1) * dilate[i] + 1)) % stride[i]
                    for i in range(ns))
    bias = maybe_bias[0] if maybe_bias and not no_bias else None
    x, w = data, weight
    if data.device.type == "cpu" and data.dtype in _LOWP:
        x, w = data.float(), weight.float()
    native = all(a < max(s, d) for a, s, d in zip(adj, stride, dilate))
    out = _CONV_T[ns](x, w, stride=stride, groups=num_group,
                      dilation=dilate,
                      padding=pad if native else 0,
                      output_padding=adj if native else 0)
    if not native:
        # the full output, cut to the padded window and padded with the
        # zeros past its end
        flat = []
        for i in reversed(range(ns)):
            size = (data.shape[2 + i] - 1) * stride[i] - 2 * pad[i] \
                + (kernel[i] - 1) * dilate[i] + 1 + adj[i]
            flat += [-pad[i], size + pad[i] - out.shape[2 + i]]
        out = F.pad(out, flat)
    out = out.to(data.dtype)
    return out if bias is None else out + bias.view((1, -1) + (1,) * ns)


# ---------------------------------------------------------------------------
# Pooling
# ---------------------------------------------------------------------------

def _pool_pads(in_sz, k, s, p, convention):
    """(lo, hi) padding of one spatial dim for the valid/full
    conventions."""
    if convention == "full":
        out = int(np.ceil((in_sz + 2 * p - k) / s)) + 1
    else:
        out = (in_sz + 2 * p - k) // s + 1
    needed = (out - 1) * s + k - in_sz - p
    return (p, max(needed, p))


@register("Pooling", aliases=("Pooling_v1",))
def _pooling(data, kernel=(), pool_type="max", global_pool=False, stride=(),
             pad=(), pooling_convention="valid", count_include_pad=True,
             p_value=2, cudnn_off=False, layout=None):
    """``layout="NHWC"`` (NWC, NDHWC) pools channels-last data, viewed
    as NCHW in channels-last memory as Convolution does."""
    ns = data.ndim - 2
    if _channels_last(layout, ns):
        return _from_nc(_pooling(
            _to_nc(data, ns), kernel, pool_type, global_pool, stride, pad,
            pooling_convention, count_include_pad, p_value), ns)
    axes = tuple(range(2, data.ndim))
    if global_pool:
        if pool_type == "max":
            return data.amax(dim=axes, keepdim=True)
        if pool_type in ("avg", "sum"):
            r = data.sum(dim=axes, keepdim=True)
            if pool_type == "avg":
                r = r / int(np.prod([data.shape[a] for a in axes]))
            return r
        if pool_type == "lp":
            return data.abs().pow(p_value).sum(dim=axes, keepdim=True) \
                .pow(1.0 / p_value)
        raise MXNetError("unknown pool_type %r" % pool_type)
    kernel = tuple(kernel)
    stride = _norm_tuple(stride, ns, 1)
    pad = _norm_tuple(pad, ns, 0)
    pads = [_pool_pads(data.shape[2 + i], kernel[i], stride[i], pad[i],
                       pooling_convention) for i in range(ns)]
    native = all(lo == hi and 2 * lo <= k
                 for (lo, hi), k in zip(pads, kernel))
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]  # F.pad order
    if pool_type == "max":
        if native:
            return _MAX_POOL[ns](data, kernel, stride,
                                 tuple(lo for lo, _ in pads))
        x = F.pad(data, flat, value=float("-inf"))
        return _MAX_POOL[ns](x, kernel, stride)
    size = int(np.prod(kernel))
    if pool_type in ("avg", "sum"):
        x = F.pad(data, flat)
        s = _AVG_POOL[ns](x, kernel, stride) * size
        if pool_type == "sum":
            return s
        if count_include_pad:
            return s / size
        ones = F.pad(torch.ones_like(data), flat)
        return s / (_AVG_POOL[ns](ones, kernel, stride) * size)
    if pool_type == "lp":
        x = F.pad(data.abs().pow(p_value), flat)
        return (_AVG_POOL[ns](x, kernel, stride) * size).pow(1.0 / p_value)
    raise MXNetError("unknown pool_type %r" % pool_type)


# ---------------------------------------------------------------------------
# BatchNorm
# ---------------------------------------------------------------------------

def _batch_stats(x, axes):
    """The batch mean and biased variance (the JAX package's
    ``_single_pass_stats``, computed stably)."""
    var, mean = torch.var_mean(x, dim=axes, correction=0)
    return mean, var


@register("BatchNorm", num_outputs=3, train_aware=True,
          aliases=("BatchNorm_v1",),
          visible_outputs=lambda attrs: 3 if attrs.get("output_mean_var")
          else 1)
def _batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
                momentum=0.9, fix_gamma=True, use_global_stats=False,
                output_mean_var=False, axis=1, cudnn_off=False,
                is_train=False):
    """Returns (out, mean, var); the caller updates the moving stats.
    The arithmetic is in float32 at least (float64 stays float64), the
    output in the input's dtype."""
    acc = torch.promote_types(data.dtype, torch.float32)
    ax = axis % data.ndim
    axes = tuple(i for i in range(data.ndim) if i != ax)
    bshape = [1] * data.ndim
    bshape[ax] = data.shape[ax]
    x = data.to(acc)
    g = torch.ones_like(gamma) if fix_gamma else gamma
    if is_train and not use_global_stats:
        mean, var = _batch_stats(x, axes)
    else:
        mean, var = moving_mean.to(acc), moving_var.to(acc)
    inv = g.to(acc).reshape(bshape) / torch.sqrt(var.reshape(bshape) + eps)
    out = (x - mean.reshape(bshape)) * inv + beta.to(acc).reshape(bshape)
    return out.to(data.dtype), mean, var


# ---------------------------------------------------------------------------
# Activation
# ---------------------------------------------------------------------------

_ACTIVATIONS = {"relu": torch.relu, "sigmoid": torch.sigmoid,
                "tanh": torch.tanh, "softrelu": F.softplus,
                "softsign": F.softsign}


@register("Activation")
def _activation(data, act_type="relu"):
    try:
        return _ACTIVATIONS[act_type](data)
    except KeyError:
        raise MXNetError("unknown act_type %r" % act_type) from None


@register("relu")
def _relu(x):
    return torch.relu(x)


@register("sigmoid")
def _sigmoid(x):
    return torch.sigmoid(x)


@register("hard_sigmoid")
def _hard_sigmoid(x, alpha=0.2, beta=0.5):
    return clip_tensor(alpha * x + beta, 0.0, 1.0)


@register("softsign")
def _softsign(x):
    return x / (1 + torch.abs(x))


# ---------------------------------------------------------------------------
# Softmax family
# ---------------------------------------------------------------------------

@register("softmax")
def _softmax(data, axis=-1, temperature=None, dtype=None, length=None):
    x = data / temperature if temperature else data
    out = torch.softmax(x, dim=axis)
    return out.to(torch_dtype(dtype)) if dtype else out


@register("softmin")
def _softmin(data, axis=-1, temperature=None, dtype=None):
    x = -data / temperature if temperature else -data
    return torch.softmax(x, dim=axis)


@register("log_softmax")
def _log_softmax(data, axis=-1, temperature=None, dtype=None):
    x = data / temperature if temperature else data
    return torch.log_softmax(x, dim=axis)


@register("softmax_cross_entropy")
def _softmax_cross_entropy(data, label):
    """The summed cross-entropy of the rows of ``data`` against the
    class ids ``label`` (a scalar), as the reference's; an id outside
    the classes adds nothing."""
    logp = torch.log_softmax(data, dim=-1)
    classes = torch.arange(data.shape[-1], device=data.device)
    hot = (label.long().unsqueeze(-1) == classes).to(data.dtype)
    return -(logp * hot).sum()


# ---------------------------------------------------------------------------
# Dropout
# ---------------------------------------------------------------------------

@register("Dropout", needs_rng=True, train_aware=True)
def _dropout(gen, data, p=0.5, mode="training", axes=(), cudnn_off=False,
             is_train=False):
    if not (mode == "always" or is_train) or p <= 0.0:
        return data
    shape = list(data.shape)
    for a in axes or ():
        shape[a] = 1
    keep = 1.0 - p
    mask = torch.empty(shape, device=data.device).bernoulli_(
        keep, generator=gen).to(data.dtype)
    return data * mask / keep


# ---------------------------------------------------------------------------
# SoftmaxOutput: its own gradient, whatever the head gradient
# ---------------------------------------------------------------------------

class _SoftmaxOutput(torch.autograd.Function):
    """Forward: softmax of ``data`` over the class axis.  Backward:
    ``(p - onehot(label)) * grad_scale`` (masked by ``ignore_label``
    under ``use_ignore``), over the batch (``normalization="batch"``) or
    the valid count (``"valid"``); the head gradient is ignored and the
    label gets zeros."""

    @staticmethod
    def forward(ctx, data, label, grad_scale, ignore_label, multi_output,
                use_ignore, normalization, smooth_alpha):
        axis = 1 if multi_output else -1
        p = torch.softmax(data, dim=axis)
        ctx.save_for_backward(p, label)
        ctx.cfg = (grad_scale, ignore_label, multi_output, use_ignore,
                   normalization, smooth_alpha)
        return p

    @staticmethod
    def backward(ctx, g):
        p, label = ctx.saved_tensors
        (grad_scale, ignore_label, multi_output, use_ignore, normalization,
         smooth_alpha) = ctx.cfg
        axis = 1 if multi_output else -1
        n_class = p.shape[axis]
        lab = label.to(torch.int32)
        # the one-hot by comparison, as jax.nn.one_hot: a label outside
        # [0, n_class) gives a zero row (F.one_hot raises on it, and
        # checks its bounds on the host, which a CUDA graph forbids)
        classes = torch.arange(n_class, device=p.device, dtype=lab.dtype)
        if multi_output:
            oh = (lab.unsqueeze(1) == classes.reshape(
                (1, n_class) + (1,) * (lab.ndim - 1))).to(p.dtype)
        else:
            oh = (lab.reshape(p.shape[:-1]).unsqueeze(-1)
                  == classes).to(p.dtype)
        if smooth_alpha:
            oh = oh * (1.0 - smooth_alpha) + smooth_alpha / n_class
        grad = p - oh
        valid = None
        if use_ignore:
            mask = (lab != int(ignore_label)).to(p.dtype)
            if multi_output:
                grad = grad * mask.unsqueeze(1)
            else:
                grad = grad * mask.reshape(p.shape[:-1]).unsqueeze(-1)
            valid = torch.clamp(mask.sum(), min=1.0)
        scale = grad_scale
        if normalization == "batch" or (normalization == "valid"
                                        and valid is None):
            scale = scale / p.shape[0]
        elif normalization == "valid":
            scale = scale / valid
        return (grad * scale, torch.zeros_like(label), None, None, None,
                None, None, None)


@register("SoftmaxOutput", aliases=("Softmax",))
def _softmax_output(data, label, grad_scale=1.0, ignore_label=-1.0,
                    multi_output=False, use_ignore=False,
                    preserve_shape=False, normalization="null",
                    out_grad=False, smooth_alpha=0.0):
    return _SoftmaxOutput.apply(data, label.to(data.dtype), float(grad_scale),
                                float(ignore_label), bool(multi_output),
                                bool(use_ignore), str(normalization),
                                float(smooth_alpha))


# ---------------------------------------------------------------------------
# Normalization layers
# ---------------------------------------------------------------------------

def _norm_stats(x, axes):
    """Mean and biased variance over ``axes`` (kept) in float32 at
    least, as the JAX package's ``_single_pass_stats``: the one-pass
    ``E[x^2] - E[x]^2`` for bf16/fp16 inputs, the two-pass variance
    otherwise."""
    acc = torch.promote_types(x.dtype, torch.float32)
    x32 = x.to(acc)
    if x.dtype in _LOWP:
        mean = x32.mean(dim=axes, keepdim=True)
        meansq = (x32 * x32).mean(dim=axes, keepdim=True)
        return x32, mean, torch.clamp(meansq - mean * mean, min=0.0)
    var, mean = torch.var_mean(x32, dim=axes, correction=0, keepdim=True)
    return x32, mean, var


@register("LayerNorm", num_outputs=3,
          visible_outputs=lambda attrs: 3 if attrs.get("output_mean_var")
          else 1)
def _layer_norm(data, gamma, beta, axis=-1, eps=1e-5, output_mean_var=False):
    """Returns (out, mean, std): the standard deviation, not the
    variance."""
    ax = axis % data.ndim
    x32, mean, var = _norm_stats(data, (ax,))
    std = torch.sqrt(var + eps)
    norm = ((x32 - mean) / std).to(data.dtype)
    bshape = [1] * data.ndim
    bshape[ax] = data.shape[ax]
    out = norm * gamma.reshape(bshape) + beta.reshape(bshape)
    return (out, mean.squeeze(ax).to(data.dtype),
            std.squeeze(ax).to(data.dtype))


@register("InstanceNorm")
def _instance_norm(data, gamma, beta, eps=1e-3):
    x32, mean, var = _norm_stats(data, tuple(range(2, data.ndim)))
    bshape = (1, -1) + (1,) * (data.ndim - 2)
    out = (x32 - mean) / torch.sqrt(var + eps) \
        * gamma.reshape(bshape).to(x32.dtype) \
        + beta.reshape(bshape).to(x32.dtype)
    return out.to(data.dtype)


_L2_AXES = {"instance": lambda n: tuple(range(1, n)),
            "channel": lambda n: (1,),
            "spatial": lambda n: tuple(range(2, n))}


@register("L2Normalization")
def _l2_normalization(data, eps=1e-10, mode="instance"):
    if mode not in _L2_AXES:
        raise MXNetError("unknown L2Normalization mode %r" % mode)
    axes = _L2_AXES[mode](data.ndim)
    return data / torch.sqrt((data * data).sum(dim=axes, keepdim=True)
                             + eps)


@register("LRN")
def _lrn(data, alpha=1e-4, beta=0.75, knorm=2.0, nsize=5):
    """Across channels: ``x / (knorm + alpha / nsize * sum of x^2 over
    the nsize channels centred on each)^beta``."""
    half = nsize // 2
    sq = F.pad(data * data, [0, 0] * (data.ndim - 2) + [half, half])
    acc = sum(sq[:, i:i + data.shape[1]] for i in range(nsize))
    return data / torch.pow(knorm + (alpha / nsize) * acc, beta)


# ---------------------------------------------------------------------------
# LeakyReLU and its modes
# ---------------------------------------------------------------------------

_SELU_ALPHA = 1.6732632423543772848170429916717
_SELU_SCALE = 1.0507009873554804934193349852946


@register("LeakyReLU")
def _leaky_relu(data, *maybe_gamma, act_type="leaky", slope=0.25,
                lower_bound=0.125, upper_bound=0.334):
    """``leaky``, ``elu``, ``gelu`` (the exact erf form), ``selu``,
    ``prelu`` (a learned slope a channel) and ``rrelu``, whose slope is
    the midpoint of its bounds in training too, as in the reference."""
    pos = data > 0
    if act_type == "leaky":
        return torch.where(pos, data, slope * data)
    if act_type == "elu":
        return torch.where(pos, data, slope * (torch.exp(data) - 1.0))
    if act_type == "gelu":
        return F.gelu(data)
    if act_type == "selu":
        return _SELU_SCALE * torch.where(
            pos, data, _SELU_ALPHA * torch.expm1(data))
    if act_type == "prelu":
        g = maybe_gamma[0]
        if g.ndim == 1 and data.ndim > 1:
            bshape = [1] * data.ndim
            bshape[1] = g.shape[0]
            g = g.reshape(bshape)
        return torch.where(pos, data, g * data)
    if act_type == "rrelu":
        mid = (lower_bound + upper_bound) / 2.0
        return torch.where(pos, data, mid * data)
    raise MXNetError("unknown LeakyReLU act_type %r" % act_type)


@register("SoftmaxActivation")
def _softmax_activation(data, mode="instance"):
    if mode == "channel":
        return torch.softmax(data, dim=1)
    return torch.softmax(data.reshape(data.shape[0], -1), dim=-1).reshape(
        data.shape)


# ---------------------------------------------------------------------------
# Resizes (bilinear as jax.image.resize's "linear": half-pixel centres,
# antialiased when shrinking)
# ---------------------------------------------------------------------------

def _linear_resize(data, height, width):
    return F.interpolate(data, size=(int(height), int(width)),
                         mode="bilinear", align_corners=False,
                         antialias=True)


@register("_contrib_AdaptiveAvgPooling2D")
def _adaptive_avg_pool2d(data, output_size=(1, 1)):
    """Block means when the size divides, else the linear resize, as
    the reference (not ``F.adaptive_avg_pool2d``)."""
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    oh, ow = tuple(output_size) or (1, 1)
    n, c, h, w = data.shape
    if h % oh == 0 and w % ow == 0:
        return data.reshape(n, c, oh, h // oh, ow, w // ow).mean(dim=(3, 5))
    return _linear_resize(data, oh, ow)


@register("_contrib_BilinearResize2D")
def _bilinear_resize2d(data, height=0, width=0, scale_height=None,
                       scale_width=None, mode="size"):
    h, w = data.shape[2:]
    if scale_height is not None:
        height = int(round(h * scale_height))
        width = int(round(w * scale_width))
    return _linear_resize(data, height, width)


@register("UpSampling")
def _upsampling(*args, scale=1, sample_type="nearest", num_args=1,
                num_filter=0, multi_input_mode="concat", workspace=512):
    """The first input scaled by ``scale``: repeated (``nearest``) or
    the linear resize (``bilinear``, whose weight input is ignored, as
    in the reference)."""
    data = args[0]
    if sample_type == "nearest":
        return data.repeat_interleave(scale, dim=2).repeat_interleave(
            scale, dim=3)
    return _linear_resize(data, data.shape[2] * scale, data.shape[3] * scale)


# ---------------------------------------------------------------------------
# The loss heads: their own gradients, whatever the head gradient
# ---------------------------------------------------------------------------

def _one_hot(label, n_class, dtype):
    """One-hot rows by comparison, as ``jax.nn.one_hot`` of the labels
    truncated to integers: a label outside [0, n_class) gives a zero
    row."""
    classes = torch.arange(n_class, device=label.device)
    return (label.to(torch.int32).unsqueeze(-1) == classes).to(dtype)


def _head_grad(kind, data, label, cfg):
    """The gradient a head gives its data (``_LossHead``)."""
    if kind in ("linear", "mae", "logistic"):
        num = int(np.prod(data.shape[1:])) if data.ndim > 1 else 1
        if kind == "logistic":
            diff = torch.sigmoid(data) - label
        else:
            diff = data - label
        if kind == "mae":
            diff = torch.sign(diff)
        return diff * (cfg[0] / num)
    if kind == "svm":
        margin, coef, use_linear = cfg
        sign = 2 * _one_hot(label, data.shape[1], data.dtype) - 1
        dist = margin - sign * data
        viol = (dist > 0).to(data.dtype)
        if use_linear:
            return -sign * viol * coef
        return -2 * sign * dist * viol * coef
    grad_scale, normalization = cfg        # make_loss
    scale = grad_scale / data.shape[0] if normalization == "batch" \
        else grad_scale
    return torch.full_like(data, scale)


class _LossHead(torch.autograd.Function):
    """Forward: ``data`` (its sigmoid for the logistic head).  Backward:
    ``_head_grad`` for the data and zeros for the label (MakeLoss has
    none); the head gradient is never read, as the reference's heads
    never read it."""

    @staticmethod
    def forward(ctx, data, label, kind, cfg):
        ctx.save_for_backward(data, label)
        ctx.kind, ctx.cfg = kind, cfg
        return torch.sigmoid(data) if kind == "logistic" else data.clone()

    @staticmethod
    def backward(ctx, g):
        data, label = ctx.saved_tensors
        return (_head_grad(ctx.kind, data, label, ctx.cfg),
                torch.zeros_like(label) if ctx.needs_input_grad[1] else None,
                None, None)


@register("LinearRegressionOutput")
def _linear_regression_output(data, label, grad_scale=1.0):
    return _LossHead.apply(data, label, "linear", (float(grad_scale),))


@register("MAERegressionOutput")
def _mae_regression_output(data, label, grad_scale=1.0):
    return _LossHead.apply(data, label, "mae", (float(grad_scale),))


@register("LogisticRegressionOutput")
def _logistic_regression_output(data, label, grad_scale=1.0):
    return _LossHead.apply(data, label, "logistic", (float(grad_scale),))


@register("SVMOutput")
def _svm_output(data, label, margin=1.0, regularization_coefficient=1.0,
                use_linear=False):
    """The hinge's gradient, L1 (``use_linear``) or squared L2, for
    the class ids ``label``."""
    return _LossHead.apply(data, label.to(data.dtype), "svm",
                           (float(margin), float(regularization_coefficient),
                            bool(use_linear)))


@register("MakeLoss")
def _make_loss(data, grad_scale=1.0, valid_thresh=0.0, normalization="null"):
    """Identity forward; the gradient is ``grad_scale`` (over the batch
    under ``normalization="batch"``; ``"valid"`` reads as ``"null"``,
    as in the reference)."""
    return _LossHead.apply(data, None, "make_loss",
                           (float(grad_scale), str(normalization)))


# ---------------------------------------------------------------------------
# CTCLoss
# ---------------------------------------------------------------------------

_LOG_EPSILON = -1e5    # optax.ctc_loss's log(0), which the reference uses


def _ctc_recursion(logprobs, logit_pad, labels, label_pad, blank_id):
    """The reference's CTC (``optax.ctc_loss_with_forward_probs``, in
    torch): the forward log-probabilities of the blank and label states
    over time, ``log_epsilon`` standing for log(0), on (B, T, K)
    log-probabilities; returns the (B,) costs."""
    b, t, k = logprobs.shape
    n = labels.shape[1]
    labellens = n - label_pad.sum(dim=1).to(torch.int64)
    repeat = F.pad((labels[:, :-1] == labels[:, 1:]).to(logprobs.dtype),
                   (0, 1))
    hot = _one_hot(labels, k, logprobs.dtype)                 # (B, N, K)
    emit_lp = torch.einsum("btk,bnk->tbn", logprobs, hot)     # (T, B, N)
    phi_lp = logprobs[:, :, blank_id].t().unsqueeze(-1)       # (T, B, 1)
    pads = logit_pad.t().to(logprobs.dtype).unsqueeze(-1)     # (T, B, 1)
    phi = torch.full((b, n + 1), _LOG_EPSILON, dtype=logprobs.dtype,
                     device=logprobs.device)
    phi = torch.cat([torch.zeros_like(phi[:, :1]), phi[:, 1:]], dim=1)
    emit = torch.full((b, n), _LOG_EPSILON, dtype=logprobs.dtype,
                      device=logprobs.device)

    def add_phi(p, score):
        return torch.cat([p[:, :1], torch.logaddexp(p[:, 1:], score)], dim=1)

    for i in range(t):
        prev_phi_orig = phi
        prev_phi = add_phi(phi, emit + _LOG_EPSILON * repeat)
        next_emit = torch.logaddexp(prev_phi[:, :-1] + emit_lp[i],
                                    emit + emit_lp[i])
        next_phi = add_phi(prev_phi + phi_lp[i],
                           emit + phi_lp[i] + _LOG_EPSILON * (1.0 - repeat))
        pad = pads[i]
        emit = pad * emit + (1.0 - pad) * next_emit
        phi = pad * prev_phi_orig + (1.0 - pad) * next_phi
    last = add_phi(phi, emit)
    return -last.gather(1, labellens.unsqueeze(1)).squeeze(1)


@register("CTCLoss", aliases=("ctc_loss", "_contrib_CTCLoss",
                              "_contrib_ctc_loss"))
def _ctc_loss(data, label, *lengths, blank_label="first",
              use_data_lengths=False, use_label_lengths=False):
    """The CTC cost of each row: ``data`` (T, N, C) logits, ``label``
    (N, L) padded (labels <= 0 under ``blank_label="first"``, >= C - 1
    under ``"last"``, so a -1 pad is a label there; or the first
    ``label_lengths`` of a row), ``data_lengths`` (N,) frames a row;
    the blank is class 0 or C - 1."""
    t, n, c = data.shape
    li = 0
    if use_data_lengths:
        dlen = lengths[li].to(torch.int64).clamp(0, t)
        li += 1
    else:
        dlen = torch.full((n,), t, dtype=torch.int64, device=data.device)
    labels = label.to(torch.int64)
    pos = torch.arange(label.shape[1], device=data.device)
    if use_label_lengths:
        label_pad = pos >= lengths[li].to(torch.int64).unsqueeze(1)
    elif blank_label == "first":
        label_pad = labels <= 0
    else:
        label_pad = labels >= c - 1
    blank_id = 0 if blank_label == "first" else c - 1
    llen = label.shape[1] - label_pad.sum(dim=1)
    used = pos < llen.unsqueeze(1)
    logprobs = torch.log_softmax(data, dim=-1)
    # the rows F.ctc_loss reads otherwise than the reference: more
    # labels and repeats than frames, or a label outside the classes or
    # the blank among the used ones
    nxt = torch.cat([labels[:, 1:], labels[:, -1:]], dim=1)
    at_end = pos == (llen - 1).unsqueeze(1)
    repeats = ((labels == nxt) & used & ~at_end).sum(dim=1)
    bad = ((labels < 0) | (labels >= c) | (labels == blank_id)) & used
    special = (llen + repeats > dlen) | bad.any(dim=1)
    targets = torch.where(used & ~special.unsqueeze(1), labels,
                          torch.full_like(labels, (blank_id + 1) % c))
    loss = F.ctc_loss(logprobs, targets, dlen.masked_fill(special, t),
                      llen.masked_fill(special, 0), blank=blank_id,
                      reduction="none", zero_infinity=False)
    if bool(special.any()):
        rows = special.nonzero().squeeze(1)
        logit_pad = torch.arange(t, device=data.device) >= \
            dlen[rows].unsqueeze(1)
        exact = _ctc_recursion(logprobs.transpose(0, 1)[rows], logit_pad,
                               labels[rows], label_pad[rows], blank_id)
        loss = loss.index_put((rows,), exact.to(loss.dtype))
    return loss


# ---------------------------------------------------------------------------
# Sequence ops
# ---------------------------------------------------------------------------

def _seq_shape(axis, ndim, n):
    """Shapes that broadcast positions (T along ``axis``) against
    lengths (N along the other of axes 0 and 1)."""
    rest = (1,) * (ndim - 2)
    if axis == 0:
        return (n, 1) + rest, (1, -1) + rest
    return (1, n) + rest, (-1, 1) + rest


@register("SequenceMask")
def _sequence_mask(data, *maybe_len, use_sequence_length=False, value=0.0,
                   axis=0):
    if not use_sequence_length or not maybe_len:
        return data
    t = data.shape[axis]
    pshape, lshape = _seq_shape(axis, data.ndim, t)
    pos = torch.arange(t, device=data.device).reshape(pshape)
    mask = pos < maybe_len[0].reshape(lshape)
    return torch.where(mask, data, torch.as_tensor(value, dtype=data.dtype,
                                                   device=data.device))


@register("SequenceLast")
def _sequence_last(data, *maybe_len, use_sequence_length=False, axis=0):
    if not use_sequence_length or not maybe_len:
        return data.select(axis, data.shape[axis] - 1)
    idx = (maybe_len[0].to(torch.int32) - 1).clamp(0, data.shape[axis] - 1)
    _, lshape = _seq_shape(axis, data.ndim, 1)
    idx = idx.to(torch.int64).reshape(lshape).expand(
        *[1 if a == axis else s for a, s in enumerate(data.shape)])
    return data.gather(axis, idx).squeeze(axis)


@register("SequenceReverse")
def _sequence_reverse(data, *maybe_len, use_sequence_length=False, axis=0):
    """Reverses axis 0 (whatever ``axis`` says, as the reference), each
    sequence within its length; a length past the end reads outside
    the sequence, and gives NaN there, as the reference's gather
    does."""
    if not use_sequence_length or not maybe_len:
        return torch.flip(data, dims=(0,))
    t = data.shape[0]
    lens = maybe_len[0].to(torch.int32).to(torch.int64).unsqueeze(0)
    pos = torch.arange(t, device=data.device).unsqueeze(1)
    src = torch.where(pos < lens, lens - 1 - pos, pos)
    src = src.reshape((t, -1) + (1,) * (data.ndim - 2)).expand(data.shape)
    inside = (src >= 0) & (src < t)
    out = data.gather(0, src.clamp(0, t - 1))
    return torch.where(inside, out, torch.full_like(out, float("nan")))


# ---------------------------------------------------------------------------
# Small contrib ops
# ---------------------------------------------------------------------------

@register("_contrib_div_sqrt_dim")
def _div_sqrt_dim(data):
    return data / np.sqrt(data.shape[-1])


@register("_contrib_quadratic")
def _quadratic(data, a=0.0, b=0.0, c=0.0):
    return a * data * data + b * data + c


@register("IdentityAttachKLSparseReg")
def _identity_attach_kl(data, sparseness_target=0.1, penalty=0.001,
                        momentum=0.9):
    """The identity (the reference's sparsity penalty is not applied
    there either)."""
    return data
