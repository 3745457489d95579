"""``mxtpu_torch.gluon.rnn`` (counterpart of ``mxtpu/gluon/rnn/``): the
fused recurrent layers ``RNN``, ``LSTM`` and ``GRU``.  The recurrent
cells (``mxtpu/gluon/rnn/rnn_cell.py``) are not ported (ROADMAP A13)."""
from .rnn_layer import RNN, LSTM, GRU

__all__ = ["RNN", "LSTM", "GRU"]
