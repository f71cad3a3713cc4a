"""Gluon: Blocks, Parameters, layers, recurrent layers and cells
(``rnn``), losses, the Trainer, the model zoo, ``data``, ``utils`` and
``contrib`` (``cnn.DeformableConvolution``)."""
from . import contrib, data, loss, model_zoo, nn, rnn, utils
from .block import Block, CachedGraph, HybridBlock, SymbolBlock
from .parameter import Constant, Parameter, ParameterDict
from .trainer import Trainer

__all__ = ["Block", "CachedGraph", "Constant", "HybridBlock", "Parameter",
           "ParameterDict", "SymbolBlock", "Trainer", "contrib", "data", "loss",
           "model_zoo", "nn", "rnn", "utils"]
