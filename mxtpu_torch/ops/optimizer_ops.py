"""Optimizer update ops of the PyTorch port (counterpart of
``mxtpu/ops/optimizer_ops.py``: the fifteen update ops, each with the
JAX package's arithmetic, attrs and defaults).

Each returns the new weight first, then the new states; the caller
writes them back.  The optimizers' ``fused_update_multi``
(``mxtpu_torch.optimizer``) do the same arithmetic over every parameter
with ``torch._foreach_*``.
"""
from __future__ import annotations

import torch

from .registry import register


def _rescale_clip(grad, rescale_grad, clip_gradient):
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient >= 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g


@register("sgd_update", differentiable=False)
def _sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                clip_gradient=-1.0, lazy_update=True):
    g = _rescale_clip(grad, rescale_grad, clip_gradient)
    return weight - lr * (g + wd * weight)


@register("sgd_mom_update", differentiable=False, num_outputs=2)
def _sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                    rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True):
    g = _rescale_clip(grad, rescale_grad, clip_gradient)
    new_mom = momentum * mom - lr * (g + wd * weight)
    return weight + new_mom, new_mom


@register("adam_update", differentiable=False, num_outputs=3)
def _adam_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                 lazy_update=True):
    g = _rescale_clip(grad, rescale_grad, clip_gradient) + wd * weight
    new_mean = beta1 * mean + (1.0 - beta1) * g
    new_var = beta2 * var + (1.0 - beta2) * torch.square(g)
    new_w = weight - lr * new_mean / (torch.sqrt(new_var) + epsilon)
    return new_w, new_mean, new_var


@register("_sparse_adagrad_update", differentiable=False, num_outputs=2,
          aliases=("adagrad_update",))
def _adagrad_update(weight, grad, history, lr=0.01, epsilon=1e-7, wd=0.0,
                    rescale_grad=1.0, clip_gradient=-1.0):
    g = _rescale_clip(grad, rescale_grad, clip_gradient)
    new_hist = history + torch.square(g)
    new_w = weight - lr * (g / (torch.sqrt(new_hist) + epsilon) + wd * weight)
    return new_w, new_hist


@register("mp_sgd_update", differentiable=False, num_outputs=2)
def _mp_sgd_update(weight, grad, weight32, lr=0.01, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0, lazy_update=True):
    g = _rescale_clip(grad.to(weight32.dtype), rescale_grad, clip_gradient)
    new_w32 = weight32 - lr * (g + wd * weight32)
    return new_w32.to(weight.dtype), new_w32


@register("mp_sgd_mom_update", differentiable=False, num_outputs=3)
def _mp_sgd_mom_update(weight, grad, mom, weight32, lr=0.01, momentum=0.0,
                       wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                       lazy_update=True):
    g = _rescale_clip(grad.to(weight32.dtype), rescale_grad, clip_gradient)
    new_mom = momentum * mom - lr * (g + wd * weight32)
    new_w32 = weight32 + new_mom
    return new_w32.to(weight.dtype), new_mom, new_w32


@register("nag_mom_update", differentiable=False, num_outputs=2)
def _nag_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                    rescale_grad=1.0, clip_gradient=-1.0):
    """The JAX package's NAG (not ``torch.optim.SGD(nesterov=True)``):
    ``g += wd * w``, ``mom = momentum * mom + g``, ``w -= lr * (g +
    momentum * mom)``."""
    g = _rescale_clip(grad, rescale_grad, clip_gradient) + wd * weight
    new_mom = momentum * mom + g
    return weight - lr * (g + momentum * new_mom), new_mom


@register("ftml_update", differentiable=False, num_outputs=4)
def _ftml_update(weight, grad, d, v, z, lr=0.0025, beta1=0.6, beta2=0.999,
                 epsilon=1e-8, t=1, wd=0.0, rescale_grad=1.0,
                 clip_grad=-1.0, clip_gradient=-1.0):
    """``clip_gradient`` wins over the legacy ``clip_grad`` when set;
    ``t`` is the parameter's update count."""
    cg = clip_gradient if clip_gradient is not None \
        and clip_gradient >= 0 else clip_grad
    g = _rescale_clip(grad, rescale_grad, cg) + wd * weight
    new_v = beta2 * v + (1 - beta2) * torch.square(g)
    d_t = (1 - beta1 ** t) / lr * (
        torch.sqrt(new_v / (1 - beta2 ** t)) + epsilon)
    sigma_t = d_t - beta1 * d
    new_z = beta1 * z + (1 - beta1) * g - sigma_t * weight
    return -new_z / d_t, d_t, new_v, new_z


@register("ftrl_update", differentiable=False, num_outputs=3)
def _ftrl_update(weight, grad, z, n, lr=0.1, lamda1=0.01, beta=1.0, wd=0.0,
                 rescale_grad=1.0, clip_gradient=-1.0):
    """A weight whose ``|z|`` is at most ``lamda1`` becomes 0."""
    g = _rescale_clip(grad, rescale_grad, clip_gradient)
    new_n = n + torch.square(g)
    sigma = (torch.sqrt(new_n) - torch.sqrt(n)) / lr
    new_z = z + g - sigma * weight
    new_w = torch.where(
        torch.abs(new_z) > lamda1,
        -(new_z - torch.sign(new_z) * lamda1) /
        ((beta + torch.sqrt(new_n)) / lr + wd),
        torch.zeros_like(weight))
    return new_w, new_z, new_n


def _clip_weights(w, clip_weights):
    if clip_weights is not None and clip_weights > 0:
        return torch.clamp(w, -clip_weights, clip_weights)
    return w


@register("rmsprop_update", differentiable=False, num_outputs=2)
def _rmsprop_update(weight, grad, n, lr=0.001, gamma1=0.95, epsilon=1e-8,
                    wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                    clip_weights=-1.0):
    """``epsilon`` inside the square root (not torch's RMSprop)."""
    g = _rescale_clip(grad, rescale_grad, clip_gradient) + wd * weight
    new_n = gamma1 * n + (1 - gamma1) * torch.square(g)
    new_w = weight - lr * g / torch.sqrt(new_n + epsilon)
    return _clip_weights(new_w, clip_weights), new_n


@register("rmspropalex_update", differentiable=False, num_outputs=4)
def _rmspropalex_update(weight, grad, n, g_acc, delta, lr=0.001, gamma1=0.95,
                        gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                        clip_gradient=-1.0, clip_weights=-1.0):
    """Centered RMSProp: the step divides by ``sqrt(n - g_acc^2 +
    epsilon)``."""
    g = _rescale_clip(grad, rescale_grad, clip_gradient) + wd * weight
    new_n = gamma1 * n + (1 - gamma1) * torch.square(g)
    new_g = gamma1 * g_acc + (1 - gamma1) * g
    new_delta = gamma2 * delta - lr * g / torch.sqrt(
        new_n - torch.square(new_g) + epsilon)
    return (_clip_weights(weight + new_delta, clip_weights), new_n, new_g,
            new_delta)


@register("signsgd_update", differentiable=False)
def _signsgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                    clip_gradient=-1.0):
    g = _rescale_clip(grad, rescale_grad, clip_gradient)
    return weight - lr * (torch.sign(g) + wd * weight)


@register("signum_update", differentiable=False, num_outputs=2)
def _signum_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    """``wd`` enters the momentum, ``wd_lh`` decays the weight itself."""
    g = _rescale_clip(grad, rescale_grad, clip_gradient)
    new_mom = momentum * mom - (1 - momentum) * (g + wd * weight)
    return (1 - lr * wd_lh) * weight + lr * torch.sign(new_mom), new_mom


@register("_contrib_group_adagrad_update", differentiable=False,
          num_outputs=2)
def _group_adagrad_update(weight, grad, history, lr=0.01, epsilon=1e-5,
                          rescale_grad=1.0, clip_gradient=-1.0):
    """One history value a row: the mean of the row's squared
    gradient."""
    g = _rescale_clip(grad, rescale_grad, clip_gradient)
    gsq = torch.mean(torch.square(g), dim=tuple(range(1, g.ndim))) \
        if g.ndim > 1 else torch.square(g)
    new_hist = history + gsq
    scale = torch.sqrt(new_hist) + epsilon
    return weight - lr * g / scale.reshape((-1,) + (1,) * (g.ndim - 1)), \
        new_hist


@register("adadelta_update", differentiable=False, num_outputs=3)
def _adadelta_update(weight, grad, acc_g, acc_delta, rho=0.9, epsilon=1e-5,
                     wd=0.0, rescale_grad=1.0, clip_gradient=-1.0, lr=1.0):
    """``lr`` is taken and not used, as in the JAX package."""
    g = _rescale_clip(grad, rescale_grad, clip_gradient) + wd * weight
    new_acc_g = rho * acc_g + (1 - rho) * torch.square(g)
    delta = torch.sqrt(acc_delta + epsilon) / torch.sqrt(
        new_acc_g + epsilon) * g
    new_acc_delta = rho * acc_delta + (1 - rho) * torch.square(delta)
    return weight - delta, new_acc_g, new_acc_delta
