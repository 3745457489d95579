"""Operators of the PyTorch port (counterpart of ``mxtpu/ops/``).

Only the flash-attention forward is ported so far
(``mxtpu/ops/pallas_attention.py`` -> :mod:`.flash_attention`).
"""
from . import flash_attention

__all__ = ["flash_attention"]
