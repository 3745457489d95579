"""``mxtpu_torch.gluon.contrib``: the experimental gluon API
(counterpart of ``mxtpu/gluon/contrib/``; MXNet's ``gluon/contrib/``)."""
from . import data  # noqa: F401
from . import nn  # noqa: F401
from . import rnn  # noqa: F401
