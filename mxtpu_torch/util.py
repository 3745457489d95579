"""Small utilities of the PyTorch port (counterpart of
``mxtpu/util.py``)."""
import os

__all__ = ["makedirs"]


def makedirs(d):
    """Make the directory ``d`` and its parents; no error if it
    exists."""
    os.makedirs(os.path.expanduser(d), exist_ok=True)
