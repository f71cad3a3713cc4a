"""Gluon: Blocks, Parameters, layers, recurrent layers and cells
(``rnn``), losses, the Trainer, the model zoo, ``data`` and ``utils``."""
from . import data, loss, model_zoo, nn, rnn, utils
from .block import Block, CachedGraph, HybridBlock
from .parameter import Constant, Parameter, ParameterDict
from .trainer import Trainer

__all__ = ["Block", "CachedGraph", "Constant", "HybridBlock", "Parameter",
           "ParameterDict", "Trainer", "data", "loss", "model_zoo", "nn",
           "rnn", "utils"]
