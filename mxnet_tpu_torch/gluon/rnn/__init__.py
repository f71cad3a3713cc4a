"""``gluon.rnn``: the fused recurrent layers and the recurrent cells."""
from .rnn_cell import (BidirectionalCell, DropoutCell, GRUCell, LSTMCell,
                       RecurrentCell, ResidualCell, RNNCell,
                       SequentialRNNCell)
from .rnn_layer import GRU, LSTM, RNN

__all__ = ["RNN", "LSTM", "GRU", "RecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "DropoutCell", "ResidualCell",
           "BidirectionalCell"]
