"""Gluon layers (``gluon.nn``)."""
from .basic_layers import (Activation, BatchNorm, Dense, Dropout, Embedding,
                           Flatten, HybridSequential, LayerNorm)
from .conv_layers import (AvgPool2D, Conv2D, Conv2DTranspose,
                          GlobalAvgPool2D, MaxPool2D)

__all__ = ["Activation", "AvgPool2D", "BatchNorm", "Conv2D",
           "Conv2DTranspose", "Dense",
           "Dropout", "Embedding", "Flatten", "GlobalAvgPool2D",
           "HybridSequential", "LayerNorm", "MaxPool2D"]
