"""Gluon: Blocks, Parameters, layers, losses, the Trainer and the model
zoo."""
from . import loss, model_zoo, nn
from .block import Block, CachedGraph, HybridBlock
from .parameter import Parameter, ParameterDict
from .trainer import Trainer

__all__ = ["Block", "CachedGraph", "HybridBlock", "Parameter",
           "ParameterDict", "Trainer", "loss", "model_zoo", "nn"]
