"""``mx.rnn``: the symbolic RNN cells and the bucketing data iterator
(``BucketingModule``'s feeder)."""
from .io import BucketSentenceIter, encode_sentences
from .rnn_cell import (BaseRNNCell, GRUCell, LSTMCell, RNNCell, RNNParams,
                       SequentialRNNCell)

__all__ = ["BaseRNNCell", "BucketSentenceIter", "GRUCell", "LSTMCell",
           "RNNCell", "RNNParams", "SequentialRNNCell", "encode_sentences"]
