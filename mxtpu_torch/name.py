"""Automatic naming of symbols (counterpart of ``mxtpu/name.py``):
``NameManager`` and ``Prefix``, which puts a fixed prefix before every
name made in its scope."""
from .symbol.symbol import NameManager

__all__ = ["NameManager", "Prefix"]


class Prefix(NameManager):
    """``with mx.name.Prefix("enc_"):`` prefixes every symbol's name."""

    def __init__(self, prefix: str):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        return self._prefix + super().get(name, hint)
