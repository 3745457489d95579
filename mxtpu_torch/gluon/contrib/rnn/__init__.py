"""Experimental recurrent cells (counterpart of
``mxtpu/gluon/contrib/rnn/``)."""
from . import conv_rnn_cell  # noqa: F401
from . import rnn_cell  # noqa: F401
from .conv_rnn_cell import *  # noqa: F401,F403
from .rnn_cell import LSTMPCell, VariationalDropoutCell  # noqa: F401
