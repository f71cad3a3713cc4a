"""Gluon: Blocks, Parameters, layers, losses, the Trainer, the model
zoo and ``utils``."""
from . import loss, model_zoo, nn, utils
from .block import Block, CachedGraph, HybridBlock
from .parameter import Constant, Parameter, ParameterDict
from .trainer import Trainer

__all__ = ["Block", "CachedGraph", "Constant", "HybridBlock", "Parameter",
           "ParameterDict", "Trainer", "loss", "model_zoo", "nn", "utils"]
