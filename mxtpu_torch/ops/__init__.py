"""Operators of the PyTorch port (counterpart of ``mxtpu/ops/``).

Only flash attention is ported so far, forward and backward
(``mxtpu/ops/pallas_attention.py`` -> :mod:`.flash_attention`).
"""
from . import flash_attention

__all__ = ["flash_attention"]
