"""Gluon: Blocks, Parameters, layers, recurrent layers and cells
(``rnn``), losses, the Trainer, the model zoo, ``data``, ``utils``
(``split_data``/``split_and_load`` also here) and ``contrib``
(``cnn``, ``nn``, ``rnn``, ``estimator``)."""
from .parameter import (Constant, DeferredInitializationError, Parameter,
                        ParameterDict)
from .block import Block, CachedGraph, HybridBlock, SymbolBlock
from .trainer import Trainer
from . import data, loss, model_zoo, nn, rnn, utils
from .utils import split_and_load, split_data
from . import contrib

__all__ = ["Block", "CachedGraph", "Constant",
           "DeferredInitializationError", "HybridBlock", "Parameter",
           "ParameterDict", "SymbolBlock", "Trainer", "contrib", "data",
           "loss", "model_zoo", "nn", "rnn", "split_and_load", "split_data",
           "utils"]
