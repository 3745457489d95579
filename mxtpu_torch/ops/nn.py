"""Neural-network ops of the PyTorch port: the ResNet set.

Counterpart of part of ``mxtpu/ops/nn.py``: ``FullyConnected``,
``Convolution``, ``Pooling``, ``BatchNorm``, ``Activation``, ``relu``,
``sigmoid``, ``hard_sigmoid``, ``softsign``, ``softmax``, ``softmin``,
``log_softmax``, ``softmax_cross_entropy``, ``Dropout`` and
``SoftmaxOutput``, with
the reference's names, attrs and NCHW/OIHW layouts.  Convolution and
the products are torch's calls (cuDNN and cuBLAS on the card, float32
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
* Dropout keeps each element (or each slice along ``axes``) with
  probability ``1 - p`` and scales the kept ones by ``1 / (1 - p)``,
  drawing from the device's generator; outside training (and ``mode``
  not ``always``) it is the identity.  The draws differ from the JAX
  package's; the distribution is the same.
* Pooling pads per ``_pool_pads`` (``valid``/``full``); torch's pooling
  takes only a symmetric pad of at most half the kernel, so any other
  pad is applied explicitly (-inf for max, zeros for avg/sum).
"""
from __future__ import annotations

import functools

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


def _check_layout(layout, ns):
    if layout and str(layout).upper() != "NC" + _SPATIAL[ns]:
        raise MXNetError("layout %r is not ported (NC%s only)"
                         % (layout, _SPATIAL[ns]))


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
    ns = len(kernel)
    _check_layout(layout, ns)
    bias = maybe_bias[0] if maybe_bias and not no_bias else None
    conv = functools.partial(_CONV[ns], stride=_norm_tuple(stride, ns, 1),
                             padding=_norm_tuple(pad, ns, 0),
                             dilation=_norm_tuple(dilate, ns, 1),
                             groups=num_group)
    if data.device.type == "cpu" and data.dtype in _LOWP:
        # products of low-precision inputs accumulate in float32 and
        # round once, as XLA's and cuDNN's do (torch's CPU kernel rounds
        # more); the bias is added after that rounding, as the JAX
        # package's add and torch's cuDNN path add it
        out = conv(data.float(), weight.float()).to(data.dtype)
        return out if bias is None else out + bias.view((1, -1) + (1,) * ns)
    return conv(data, weight, bias)


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
    ns = data.ndim - 2
    _check_layout(layout, ns)
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
