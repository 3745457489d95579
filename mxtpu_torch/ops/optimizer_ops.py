"""Optimizer update ops of the PyTorch port (counterpart of
``sgd_update``, ``sgd_mom_update``, ``adam_update`` and
``_sparse_adagrad_update`` in ``mxtpu/ops/optimizer_ops.py``).

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
