"""Random number state of the PyTorch port.

Counterpart of ``mxtpu/random.py``: ``seed`` and the samplers
``uniform`` and ``normal``.  Where the JAX package splits one threefry
key chain, the port keeps one ``torch.Generator`` per device: ``seed``
reseeds every one of them (and any made later) from the same number, so
a fixed seed and a fixed sequence of draws reproduce the same values on
a device.  The two packages draw different numbers for the same seed.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

import numpy as np
import torch

from .base import getenv_int

__all__ = ["seed", "uniform", "normal", "generator"]

_lock = threading.Lock()
_generators: Dict[torch.device, torch.Generator] = {}
_seed_value: Optional[int] = getenv_int("MXNET_TEST_SEED", 0) or None


def seed(seed_state: int):
    """Seed every device's generator (reference ``mx.random.seed``)."""
    global _seed_value
    with _lock:
        _seed_value = int(seed_state)
        _generators.clear()


def generator(device) -> torch.Generator:
    """The generator of ``device``, made from the current seed (or a
    random one when none was set) the first time it is asked for."""
    dev = torch.device(device)
    with _lock:
        gen = _generators.get(dev)
        if gen is None:
            s = _seed_value if _seed_value is not None \
                else np.random.randint(0, 2 ** 31 - 1)
            gen = _generators[dev] = torch.Generator(dev).manual_seed(s)
        return gen


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
