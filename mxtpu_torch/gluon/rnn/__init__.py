"""``mxtpu_torch.gluon.rnn`` (counterpart of ``mxtpu/gluon/rnn/``): the
fused recurrent layers ``RNN``, ``LSTM`` and ``GRU`` and the recurrent
cells of :mod:`.rnn_cell`."""
from . import rnn_cell
from .rnn_layer import RNN, LSTM, GRU
from .rnn_cell import (RecurrentCell, HybridRecurrentCell, RNNCell,
                       LSTMCell, GRUCell, SequentialRNNCell, DropoutCell,
                       ResidualCell, ZoneoutCell, BidirectionalCell)

__all__ = ["RNN", "LSTM", "GRU", "RecurrentCell", "HybridRecurrentCell",
           "RNNCell", "LSTMCell", "GRUCell", "SequentialRNNCell",
           "DropoutCell", "ResidualCell", "ZoneoutCell", "BidirectionalCell"]
