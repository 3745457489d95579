"""Logging helpers of the PyTorch port: ``mx.log.get_logger``.

Counterpart of ``mxtpu/log.py``: a logger whose records carry their
level's initial, the time and the logger's name, coloured when stderr
is a terminal, written to ``filename`` when one is given.  The handler
and level are installed on a logger's first ``get_logger`` only, and the
root logger (``name=None``) is returned untouched.
"""
import logging
import sys
import warnings

__all__ = ["get_logger", "getLogger"]

_COLORS = {"WARNING": "\x1b[0;33m", "ERROR": "\x1b[0;31m",
           "CRITICAL": "\x1b[0;35m", "DEBUG": "\x1b[0;34m",
           "INFO": "\x1b[0;32m"}


class _Formatter(logging.Formatter):
    def __init__(self, colored):
        self._colored = colored
        super().__init__(datefmt="%m%d %H:%M:%S")

    def format(self, record):
        label = record.levelname[0]
        if self._colored:
            label = _COLORS.get(record.levelname, "") + label + "\x1b[0m"
        self._style._fmt = ("[%s %%(asctime)s %%(name)s] %%(message)s"
                            % label)
        return super().format(record)


def get_logger(name=None, filename=None, filemode=None,
               level=logging.WARNING):
    """The logger ``name`` with the format above (and ``level``), set up
    the first time it is asked for; the root logger as it is."""
    logger = logging.getLogger(name)
    if name is None or getattr(logger, "_mxtpu_init", False):
        return logger
    if filename:
        handler = logging.FileHandler(filename, filemode or "a")
        colored = False
    else:
        handler = logging.StreamHandler()
        colored = getattr(sys.stderr, "isatty", lambda: False)()
    handler.setFormatter(_Formatter(colored))
    logger.addHandler(handler)
    logger.setLevel(level)
    logger._mxtpu_init = True
    return logger


def getLogger(*args, **kwargs):
    """Deprecated alias of :func:`get_logger`."""
    warnings.warn("getLogger is deprecated, use get_logger",
                  DeprecationWarning)
    return get_logger(*args, **kwargs)
