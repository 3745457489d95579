"""Random number state of the PyTorch port.

Counterpart of ``mxtpu/random.py``: ``seed``, ``get_state``/
``set_state`` and the samplers.  Where the JAX package splits one
threefry key chain, the port keeps one ``torch.Generator`` per device:
``seed`` reseeds every one of them (and any made later) from the same
number, so a fixed seed and a fixed sequence of draws reproduce the
same values on a device.  ``get_state`` captures the seed and every
generator's state; after ``set_state`` of it the same draws come again,
bit for bit, and ``set_state(None)`` starts every device over from the
seed.  The two packages draw different numbers for the same seed.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

import numpy as np
import torch

from .base import getenv_int
from .context import torch_device

__all__ = ["seed", "uniform", "normal", "randint", "randn", "exponential",
           "poisson", "gamma", "negative_binomial",
           "generalized_negative_binomial", "multinomial", "shuffle",
           "get_state", "set_state", "generator"]

_lock = threading.Lock()
_generators: Dict[torch.device, torch.Generator] = {}
_seed_value: Optional[int] = getenv_int("MXNET_TEST_SEED", 0) or None


def seed(seed_state: int, ctx=None):
    """Seed every device's generator (reference ``mx.random.seed``;
    ``ctx`` is taken for its signature: every device is reseeded)."""
    global _seed_value
    with _lock:
        _seed_value = int(seed_state)
        _generators.clear()


def generator(device) -> torch.Generator:
    """The generator of ``device``, made from the current seed the first
    time it is asked for (a random seed is chosen, once, when none was
    set)."""
    global _seed_value
    dev = torch_device(device)
    with _lock:
        gen = _generators.get(dev)
        if gen is None:
            if _seed_value is None:
                _seed_value = int(np.random.randint(0, 2 ** 31 - 1))
            gen = _generators[dev] = \
                torch.Generator(dev).manual_seed(_seed_value)
        return gen


def get_state():
    """The seed and each device's generator state (host tensors), for
    ``set_state``."""
    with _lock:
        return {"seed": _seed_value,
                "generators": {str(d): g.get_state()
                               for d, g in _generators.items()}}


def set_state(state) -> None:
    """Restore what ``get_state`` returned: the draws that followed it
    come again.  A device whose generator was not made yet starts from
    the seed; ``None`` starts every device over from the seed."""
    global _seed_value
    with _lock:
        _generators.clear()
        if state is None:
            return
        _seed_value = state["seed"]
        for dev, st in state["generators"].items():
            d = torch.device(dev)
            gen = torch.Generator(d)
            gen.set_state(st)
            _generators[d] = gen


def _shape(shape):
    if shape is None or shape == ():
        return ()
    if isinstance(shape, int):
        return (shape,)
    return tuple(int(s) for s in shape)


def _invoke(name, **kwargs):
    from .ndarray.ndarray import imperative_invoke

    out = kwargs.pop("out", None)
    return imperative_invoke(name, out=out, **kwargs)[0]


def uniform(low=0.0, high=1.0, shape=(), dtype="float32", ctx=None,
            out=None):
    return _invoke("_random_uniform", low=float(low), high=float(high),
                   shape=_shape(shape), dtype=dtype, ctx=ctx, out=out)


def normal(loc=0.0, scale=1.0, shape=(), dtype="float32", ctx=None,
           out=None):
    return _invoke("_random_normal", loc=float(loc), scale=float(scale),
                   shape=_shape(shape), dtype=dtype, ctx=ctx, out=out)


def randn(*shape, dtype="float32", ctx=None):
    return normal(0.0, 1.0, shape=tuple(shape) or (1,), dtype=dtype, ctx=ctx)


def randint(low, high=None, shape=(1,), dtype="int32", ctx=None, out=None):
    if high is None:
        low, high = 0, low
    return _invoke("_random_randint", low=int(low), high=int(high),
                   shape=_shape(shape), dtype=dtype, ctx=ctx, out=out)


def exponential(scale=1.0, shape=(), dtype="float32", ctx=None, out=None):
    return _invoke("_random_exponential", lam=1.0 / float(scale),
                   shape=_shape(shape), dtype=dtype, ctx=ctx, out=out)


def poisson(lam=1.0, shape=(), dtype="float32", ctx=None, out=None):
    return _invoke("_random_poisson", lam=float(lam), shape=_shape(shape),
                   dtype=dtype, ctx=ctx, out=out)


def gamma(alpha=1.0, beta=1.0, shape=(), dtype="float32", ctx=None,
          out=None):
    return _invoke("_random_gamma", alpha=float(alpha), beta=float(beta),
                   shape=_shape(shape), dtype=dtype, ctx=ctx, out=out)


def negative_binomial(k=1, p=1.0, shape=(), dtype="float32", ctx=None,
                      out=None):
    return _invoke("_random_negative_binomial", k=int(k), p=float(p),
                   shape=_shape(shape), dtype=dtype, ctx=ctx, out=out)


def generalized_negative_binomial(mu=1.0, alpha=1.0, shape=(),
                                  dtype="float32", ctx=None, out=None):
    return _invoke("_random_generalized_negative_binomial", mu=float(mu),
                   alpha=float(alpha), shape=_shape(shape), dtype=dtype,
                   ctx=ctx, out=out)


def multinomial(data, shape=(), get_prob=False, dtype="int32", out=None):
    """Draws from each row of probabilities ``data``; with ``get_prob``,
    (the draws, their log-probabilities)."""
    from .ndarray.ndarray import imperative_invoke

    res = imperative_invoke("_sample_multinomial", data,
                            shape=shape if shape else 1, get_prob=get_prob,
                            dtype=dtype, out=out, _full_outputs=get_prob)
    return res if get_prob else res[0]


def shuffle(data, out=None):
    from .ndarray.ndarray import imperative_invoke

    return imperative_invoke("_shuffle", data, out=out)[0]
