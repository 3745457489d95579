"""Random samplers of the PyTorch port (counterpart of
``mxtpu/ops/random_ops.py``: the 31 names of its samplers, with their
attrs and defaults).  Each takes the ``torch.Generator`` of the device
it draws on (``mxtpu_torch.random``) where the JAX package's take a
PRNG key, and draws only through torch calls that take it
(``uniform_``, ``normal_``, ``exponential_``, ``torch._standard_gamma``,
``torch.poisson``, ``torch.randint``, ``torch.multinomial``,
``torch.rand``, ``torch.randperm``), so the two packages draw
different numbers from the same distributions.

The contracts kept: the negative binomials are gamma-Poisson mixtures;
``randint`` excludes ``high`` and defaults to int32; a ``*_like`` op
takes its input's shape and dtype; a ``_sample_*`` op's output is its
parameters' shape followed by ``shape``; ``_sample_multinomial`` draws
from ``log(max(p, 1e-37))``, returns int32 (a 1-D input gives a flat
output) and, with ``get_prob``, the log-softmax at the draws;
``_sample_unique_zipfian`` returns only the indices, unique within each
row, by Gumbel top-k over the log-uniform class probabilities
(``ValueError`` when a row asks for more than ``range_max``);
``_shuffle`` permutes axis 0.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import torch_dtype
from .registry import get_op, register


def _empty(shape, dtype, device):
    return torch.empty(tuple(shape) if shape else (),
                       dtype=torch_dtype(dtype or "float32"), device=device)


def _gamma(gen, alpha, out_shape, device):
    """Standard gamma draws of shape ``out_shape`` (``alpha`` a number or
    a tensor broadcast to it), in float32."""
    a = torch.as_tensor(alpha, dtype=torch.float32, device=device)
    return torch._standard_gamma(a.expand(out_shape).contiguous(),
                                 generator=gen)


@register("_random_uniform", needs_rng=True, differentiable=False,
          aliases=("uniform", "random_uniform"))
def _random_uniform(gen, low=0.0, high=1.0, shape=(), dtype="float32",
                    device=None):
    return _empty(shape, dtype, device).uniform_(low, high, generator=gen)


@register("_random_normal", needs_rng=True, differentiable=False,
          aliases=("normal", "random_normal"))
def _random_normal(gen, loc=0.0, scale=1.0, shape=(), dtype="float32",
                   device=None):
    return _empty(shape, dtype, device).normal_(loc, scale, generator=gen)


@register("_random_gamma", needs_rng=True, differentiable=False,
          aliases=("random_gamma",))
def _random_gamma(gen, alpha=1.0, beta=1.0, shape=(), dtype="float32",
                  device=None):
    out = _empty(shape, dtype, device)
    return (_gamma(gen, alpha, out.shape, device) * beta).to(out.dtype)


@register("_random_exponential", needs_rng=True, differentiable=False,
          aliases=("random_exponential",))
def _random_exponential(gen, lam=1.0, shape=(), dtype="float32",
                        device=None):
    return _empty(shape, dtype, device).exponential_(1.0, generator=gen) / lam


@register("_random_poisson", needs_rng=True, differentiable=False,
          aliases=("random_poisson",))
def _random_poisson(gen, lam=1.0, shape=(), dtype="float32", device=None):
    out = _empty(shape, dtype, device)
    rate = torch.full(out.shape, float(lam), dtype=torch.float32,
                      device=device)
    return torch.poisson(rate, generator=gen).to(out.dtype)


def _poisson_of_gamma(gen, shape_k, scale, out_shape, device):
    """Poisson draws whose rates are gamma(shape_k) * scale: the
    negative binomial as a gamma-Poisson mixture."""
    lam = _gamma(gen, shape_k, out_shape, device) * scale
    return torch.poisson(lam, generator=gen)


@register("_random_negative_binomial", needs_rng=True, differentiable=False,
          aliases=("random_negative_binomial",))
def _random_negative_binomial(gen, k=1, p=1.0, shape=(), dtype="float32",
                              device=None):
    out = _empty(shape, dtype, device)
    return _poisson_of_gamma(gen, k, (1 - p) / p, out.shape,
                             device).to(out.dtype)


@register("_random_generalized_negative_binomial", needs_rng=True,
          differentiable=False,
          aliases=("random_generalized_negative_binomial",))
def _random_gen_neg_binomial(gen, mu=1.0, alpha=1.0, shape=(),
                             dtype="float32", device=None):
    out = _empty(shape, dtype, device)
    r = 1.0 / alpha
    p = r / (r + mu)
    return _poisson_of_gamma(gen, r, (1 - p) / p, out.shape,
                             device).to(out.dtype)


@register("_random_randint", needs_rng=True, differentiable=False,
          aliases=("random_randint",))
def _random_randint(gen, low=0, high=1, shape=(), dtype="int32",
                    device=None):
    shape = tuple(shape) if shape else ()
    return torch.randint(int(low), int(high), shape, generator=gen,
                         device=device).to(torch_dtype(dtype or "int32"))


def _like(name, base):
    def _op(gen, data, **attrs):
        attrs.pop("shape", None)
        attrs.pop("dtype", None)
        return get_op(base).fn(gen, shape=tuple(data.shape),
                               dtype=str(data.dtype).replace("torch.", ""),
                               device=data.device, **attrs)

    _op.__name__ = name
    register(name, needs_rng=True, differentiable=False)(_op)


_like("_random_uniform_like", "_random_uniform")
_like("_random_normal_like", "_random_normal")
_like("_random_gamma_like", "_random_gamma")
_like("_random_exponential_like", "_random_exponential")
_like("_random_poisson_like", "_random_poisson")
_like("_random_negative_binomial_like", "_random_negative_binomial")
_like("_random_generalized_negative_binomial_like",
      "_random_generalized_negative_binomial")


# the multisample family: one distribution per element of the parameters,
# ``shape`` draws from each
def _per_param(p, shape):
    """(the output shape, ``p`` reshaped to broadcast against it)."""
    shape = tuple(shape) if shape else ()
    return tuple(p.shape) + shape, p.reshape(tuple(p.shape) +
                                             (1,) * len(shape))


@register("_sample_uniform", needs_rng=True, differentiable=False)
def _sample_uniform(gen, low, high, shape=(), dtype="float32"):
    out, lo = _per_param(low, shape)
    _, hi = _per_param(high, shape)
    u = _empty(out, dtype, low.device).uniform_(0.0, 1.0, generator=gen)
    return lo + u * (hi - lo)


@register("_sample_normal", needs_rng=True, differentiable=False)
def _sample_normal(gen, mu, sigma, shape=(), dtype="float32"):
    out, m = _per_param(mu, shape)
    _, s = _per_param(sigma, shape)
    z = _empty(out, dtype, mu.device).normal_(0.0, 1.0, generator=gen)
    return m + z * s


@register("_sample_gamma", needs_rng=True, differentiable=False)
def _sample_gamma(gen, alpha, beta, shape=(), dtype="float32"):
    out, a = _per_param(alpha, shape)
    _, b = _per_param(beta, shape)
    g = _gamma(gen, a, out, alpha.device).to(torch_dtype(dtype or
                                                        "float32"))
    return g * b


@register("_sample_exponential", needs_rng=True, differentiable=False)
def _sample_exponential(gen, lam, shape=(), dtype="float32"):
    out, rate = _per_param(lam, shape)
    e = _empty(out, dtype, lam.device).exponential_(1.0, generator=gen)
    return e / rate


@register("_sample_poisson", needs_rng=True, differentiable=False)
def _sample_poisson(gen, lam, shape=(), dtype="float32"):
    out, rate = _per_param(lam, shape)
    return torch.poisson(rate.float().expand(out).contiguous(),
                         generator=gen).to(torch_dtype(dtype or "float32"))


@register("_sample_negative_binomial", needs_rng=True, differentiable=False)
def _sample_negative_binomial(gen, k, p, shape=(), dtype="float32"):
    out, kk = _per_param(k, shape)
    _, pp = _per_param(p, shape)
    return _poisson_of_gamma(gen, kk, (1 - pp) / pp, out, k.device).to(
        torch_dtype(dtype or "float32"))


@register("_sample_generalized_negative_binomial", needs_rng=True,
          differentiable=False)
def _sample_gen_neg_binomial(gen, mu, alpha, shape=(), dtype="float32"):
    out, m = _per_param(mu, shape)
    _, a = _per_param(alpha, shape)
    r = 1.0 / a
    p = r / (r + m)
    return _poisson_of_gamma(gen, r, (1 - p) / p, out, mu.device).to(
        torch_dtype(dtype or "float32"))


def _multinomial_outputs(attrs):
    return 2 if attrs.get("get_prob") else 1


# ``nd``'s call shows the draws alone, as the JAX package's does;
# ``random.multinomial(get_prob=True)`` takes both outputs
@register("_sample_multinomial", needs_rng=True, differentiable=False,
          num_outputs=_multinomial_outputs, visible_outputs=1,
          aliases=("sample_multinomial",))
def _sample_multinomial(gen, data, shape=(), get_prob=False, dtype="int32"):
    """``n`` draws (``shape`` or its first element) from each row of
    probabilities (the last axis), as the last axis of the output."""
    n = int(shape if isinstance(shape, int) else (shape[0] if shape else 1))
    logits = torch.log(torch.clamp(data, min=1e-37))
    k = data.shape[-1]
    rows = logits.reshape(-1, k)
    draws = torch.multinomial(torch.softmax(rows.float(), dim=-1), n,
                              replacement=True, generator=gen)
    out = draws.reshape(tuple(data.shape[:-1]) + (n,))
    if data.ndim == 1:
        out = out.reshape(-1)
    out = out.to(torch_dtype(dtype or "int32"))
    if get_prob:
        lp = torch.gather(torch.log_softmax(rows, dim=-1), -1, draws)
        return out, lp.reshape(out.shape)
    return out


@register("_sample_unique_zipfian", needs_rng=True, differentiable=False)
def _sample_unique_zipfian(gen, range_max=1, shape=(), device=None):
    """Draws without replacement from the log-uniform class distribution
    ``p(c) = log((c + 2) / (c + 1)) / log(range_max + 1)``, unique
    within each row (the last axis): the top ``n`` of the classes'
    log-probabilities plus Gumbel noise."""
    shape = tuple(shape) if shape else (1,)
    n = int(shape[-1])
    if n > range_max:
        raise ValueError("_sample_unique_zipfian: cannot draw %d unique "
                         "samples from range_max=%d" % (n, range_max))
    rows = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
    c = torch.arange(range_max, dtype=torch.float32, device=device)
    logp = torch.log(torch.log1p(1.0 / (c + 1.0)))
    u = torch.rand((rows, range_max), generator=gen, device=device)
    # Gumbel noise -log(-log(u)), u kept off 0 and 1 as jax.random does
    u = u.clamp(min=torch.finfo(torch.float32).tiny, max=1.0 - 2 ** -24)
    idx = torch.topk(logp - torch.log(-torch.log(u)), n, dim=-1).indices
    # int32: the JAX package's index dtype without jax_enable_x64
    return idx.reshape(shape).to(torch.int32)


@register("_shuffle", needs_rng=True, differentiable=False,
          aliases=("shuffle",))
def _shuffle_op(gen, data):
    perm = torch.randperm(data.shape[0], generator=gen, device=data.device)
    return data[perm]
