"""DenseNet 121, 161, 169 and 201 (Huang et al. 2017), 224 x 224 input.

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision/densenet.py``: each
dense layer (BN, relu, 1x1 conv, BN, relu, 3x3 conv) concatenates its new
features onto its input; transitions halve the width and the map; a
global average pool ends the features, as there (upstream's
``AvgPool2D(7)``, the same at 224).  Creation order and parameter names
are the JAX package's.
"""
from __future__ import annotations

import torch

from ... import nn
from ...block import HybridBlock
from ._common import finish

__all__ = ["DenseNet", "densenet121", "densenet161", "densenet169",
           "densenet201"]

# num_init_features, growth_rate, block_config
_SPECS = {
    121: (64, 32, [6, 12, 24, 16]),
    161: (96, 48, [6, 12, 36, 24]),
    169: (64, 32, [6, 12, 32, 32]),
    201: (64, 32, [6, 12, 48, 32]),
}


def _make_dense_layer(growth_rate, bn_size, dropout):
    out = nn.HybridSequential(prefix="")
    out.add(nn.BatchNorm())
    out.add(nn.Activation("relu"))
    out.add(nn.Conv2D(bn_size * growth_rate, kernel_size=1, use_bias=False))
    out.add(nn.BatchNorm())
    out.add(nn.Activation("relu"))
    out.add(nn.Conv2D(growth_rate, kernel_size=3, padding=1, use_bias=False))
    if dropout:
        out.add(nn.Dropout(dropout))
    return out


class _DenseLayer(HybridBlock):
    """One dense layer: its new features concatenated onto its input."""

    def __init__(self, growth_rate, bn_size, dropout, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.body = _make_dense_layer(growth_rate, bn_size, dropout)

    def forward(self, x):
        return torch.cat([x, self.body(x)], dim=1)

    def hybrid_forward(self, F, x):
        return F.concat(x, self.body(x), dim=1)


def _make_dense_block(num_layers, bn_size, growth_rate, dropout,
                      stage_index):
    out = nn.HybridSequential(prefix=f"stage{stage_index}_")
    with out.name_scope():
        for _ in range(num_layers):
            out.add(_DenseLayer(growth_rate, bn_size, dropout))
    return out


def _make_transition(num_output_features):
    out = nn.HybridSequential(prefix="")
    out.add(nn.BatchNorm())
    out.add(nn.Activation("relu"))
    out.add(nn.Conv2D(num_output_features, kernel_size=1, use_bias=False))
    out.add(nn.AvgPool2D(pool_size=2, strides=2))
    return out


class DenseNet(HybridBlock):
    def __init__(self, num_init_features, growth_rate, block_config,
                 bn_size=4, dropout=0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(nn.Conv2D(num_init_features, kernel_size=7,
                                        strides=2, padding=3,
                                        use_bias=False))
            self.features.add(nn.BatchNorm())
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                           padding=1))
            num_features = num_init_features
            for i, num_layers in enumerate(block_config):
                self.features.add(_make_dense_block(
                    num_layers, bn_size, growth_rate, dropout, i + 1))
                num_features += num_layers * growth_rate
                if i != len(block_config) - 1:
                    num_features //= 2
                    self.features.add(_make_transition(num_features))
            self.features.add(nn.BatchNorm())
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.GlobalAvgPool2D())
            self.features.add(nn.Flatten())
            self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def _constructor(num_layers):
    def make(pretrained=False, ctx=None, **kwargs):
        init, growth, config = _SPECS[num_layers]
        return finish(DenseNet(init, growth, config, **kwargs), pretrained,
                      ctx)
    make.__name__ = make.__qualname__ = f"densenet{num_layers}"
    make.__doc__ = f"DenseNet-{num_layers}."
    return make


densenet121, densenet161, densenet169, densenet201 = (
    _constructor(n) for n in (121, 161, 169, 201))
