"""``mx.rnn``: the symbolic RNN cells and the bucketing data iterator
(``BucketingModule``'s feeder)."""
from .io import BucketSentenceIter, encode_sentences
from .rnn_cell import (BaseRNNCell, BidirectionalCell, DropoutCell,
                       FusedRNNCell, GRUCell, LSTMCell, RNNCell, RNNParams,
                       ResidualCell, SequentialRNNCell)

__all__ = ["BaseRNNCell", "BidirectionalCell", "BucketSentenceIter",
           "DropoutCell", "FusedRNNCell", "GRUCell", "LSTMCell", "RNNCell",
           "RNNParams", "ResidualCell", "SequentialRNNCell",
           "encode_sentences"]
