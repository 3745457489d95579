"""Experimental data utilities (counterpart of
``mxtpu/gluon/contrib/data/``)."""
from . import sampler  # noqa: F401
from .sampler import IntervalSampler  # noqa: F401
