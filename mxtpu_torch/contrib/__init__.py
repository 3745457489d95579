"""``mx.contrib`` of the PyTorch port (counterpart of
``mxtpu/contrib/``): INT8 post-training quantization
(:mod:`.quantization`).  ``onnx``, ``text``, ``svrg_optimization`` and
``tensorboard`` are not ported: reaching one raises an ``MXNetError``
that names ROADMAP's A19."""
from ..base import MXNetError
from . import quantization  # noqa: F401

_NOT_PORTED = ("onnx", "text", "svrg_optimization", "tensorboard")


def __getattr__(name):
    if name in _NOT_PORTED:
        raise MXNetError("mx.contrib.%s is not ported yet (ROADMAP A19)"
                         % name)
    raise AttributeError("module %r has no attribute %r" % (__name__, name))
