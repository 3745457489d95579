"""``mxtpu_torch.rnn``: the symbolic recurrent cells and the bucketing
sentence iterator (counterpart of ``mxtpu/rnn/``)."""
from .rnn_cell import (RNNParams, BaseRNNCell, RNNCell, LSTMCell, GRUCell,
                       FusedRNNCell, SequentialRNNCell, DropoutCell,
                       BidirectionalCell)
from .io import BucketSentenceIter

__all__ = ["RNNParams", "BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
           "FusedRNNCell", "SequentialRNNCell", "DropoutCell",
           "BidirectionalCell", "BucketSentenceIter"]
