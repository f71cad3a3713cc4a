"""VGG 11, 13, 16 and 19 (Simonyan and Zisserman 2014), with and without
BatchNorm, 224 x 224 input.

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision/vgg.py``: the same
stages, the same ``normal`` initializer on the dense layers, the same
creation order and parameter names; widths are inferred at the first
call, as there.
"""
from __future__ import annotations

from ....base import MXNetError
from ... import nn
from ...block import HybridBlock
from ._common import finish

__all__ = ["VGG", "vgg11", "vgg13", "vgg16", "vgg19", "vgg11_bn", "vgg13_bn",
           "vgg16_bn", "vgg19_bn", "get_vgg"]

vgg_spec = {
    11: ([1, 1, 2, 2, 2], [64, 128, 256, 512, 512]),
    13: ([2, 2, 2, 2, 2], [64, 128, 256, 512, 512]),
    16: ([2, 2, 3, 3, 3], [64, 128, 256, 512, 512]),
    19: ([2, 2, 4, 4, 4], [64, 128, 256, 512, 512]),
}


class VGG(HybridBlock):
    def __init__(self, layers, filters, classes=1000, batch_norm=False,
                 **kwargs):
        super().__init__(**kwargs)
        if len(layers) != len(filters):
            raise MXNetError(f"{len(layers)} stages, {len(filters)} widths")
        with self.name_scope():
            self.features = self._make_features(layers, filters, batch_norm)
            self.features.add(nn.Dense(4096, activation="relu",
                                       weight_initializer="normal"))
            self.features.add(nn.Dropout(rate=0.5))
            self.features.add(nn.Dense(4096, activation="relu",
                                       weight_initializer="normal"))
            self.features.add(nn.Dropout(rate=0.5))
            self.output = nn.Dense(classes, weight_initializer="normal")

    @staticmethod
    def _make_features(layers, filters, batch_norm):
        featurizer = nn.HybridSequential(prefix="")
        for i, num in enumerate(layers):
            for _ in range(num):
                featurizer.add(nn.Conv2D(filters[i], kernel_size=3,
                                         padding=1))
                if batch_norm:
                    featurizer.add(nn.BatchNorm())
                featurizer.add(nn.Activation("relu"))
            featurizer.add(nn.MaxPool2D(strides=2))
        return featurizer

    def forward(self, x):
        return self.output(self.features(x))

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def get_vgg(num_layers, pretrained=False, ctx=None, **kwargs):
    if num_layers not in vgg_spec:
        raise MXNetError(f"no vgg{num_layers}; choose from "
                         f"{sorted(vgg_spec)}")
    layers, filters = vgg_spec[num_layers]
    return finish(VGG(layers, filters, **kwargs), pretrained, ctx)


def _constructor(num_layers, batch_norm):
    def make(**kwargs):
        if batch_norm:
            kwargs["batch_norm"] = True
        return get_vgg(num_layers, **kwargs)
    make.__name__ = make.__qualname__ = \
        f"vgg{num_layers}" + ("_bn" if batch_norm else "")
    make.__doc__ = f"VGG-{num_layers}" + (" with BatchNorm." if batch_norm
                                          else ".")
    return make


vgg11, vgg13, vgg16, vgg19 = (_constructor(n, False)
                              for n in (11, 13, 16, 19))
vgg11_bn, vgg13_bn, vgg16_bn, vgg19_bn = (_constructor(n, True)
                                          for n in (11, 13, 16, 19))
