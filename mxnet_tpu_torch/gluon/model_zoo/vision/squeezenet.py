"""SqueezeNet 1.0 and 1.1 (Iandola et al. 2016), 224 x 224 input.

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision/squeezenet.py``: fire
modules (a 1x1 squeeze conv feeding a 1x1 and a 3x3 expand conv whose
outputs a ``HybridConcurrent`` joins on the channels), the ``ceil_mode``
max pools, the same creation order and parameter names.
"""
from __future__ import annotations

from ....base import MXNetError
from ... import nn
from ...block import HybridBlock
from ._common import finish

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1"]


def _make_fire(squeeze_channels, expand1x1_channels, expand3x3_channels):
    out = nn.HybridSequential(prefix="")
    out.add(nn.Conv2D(squeeze_channels, kernel_size=1, activation="relu"))
    branches = nn.HybridConcurrent(axis=1, prefix="")
    left = nn.HybridSequential(prefix="")
    left.add(nn.Conv2D(expand1x1_channels, kernel_size=1,
                       activation="relu"))
    right = nn.HybridSequential(prefix="")
    right.add(nn.Conv2D(expand3x3_channels, kernel_size=3, padding=1,
                        activation="relu"))
    branches.add(left, right)
    out.add(branches)
    return out


def _pool():
    return nn.MaxPool2D(pool_size=3, strides=2, ceil_mode=True)


# per version: the stem conv, then fires (squeeze, expand) and pools
_LAYOUT = {
    "1.0": ((96, 7), ["pool", (16, 64), (16, 64), (32, 128), "pool",
                      (32, 128), (48, 192), (48, 192), (64, 256), "pool",
                      (64, 256)]),
    "1.1": ((64, 3), ["pool", (16, 64), (16, 64), "pool", (32, 128),
                      (32, 128), "pool", (48, 192), (48, 192), (64, 256),
                      (64, 256)]),
}


class SqueezeNet(HybridBlock):
    def __init__(self, version, classes=1000, **kwargs):
        super().__init__(**kwargs)
        if version not in _LAYOUT:
            raise MXNetError("version must be '1.0' or '1.1'")
        (stem, kernel), body = _LAYOUT[version]
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(nn.Conv2D(stem, kernel_size=kernel, strides=2,
                                        activation="relu"))
            for item in body:
                self.features.add(_pool() if item == "pool" else
                                  _make_fire(item[0], item[1], item[1]))
            self.features.add(nn.Dropout(0.5))
            self.output = nn.HybridSequential(prefix="")
            self.output.add(nn.Conv2D(classes, kernel_size=1,
                                      activation="relu"))
            self.output.add(nn.GlobalAvgPool2D())
            self.output.add(nn.Flatten())

    def forward(self, x):
        return self.output(self.features(x))


def squeezenet1_0(pretrained=False, ctx=None, **kwargs):
    return finish(SqueezeNet("1.0", **kwargs), pretrained, ctx)


def squeezenet1_1(pretrained=False, ctx=None, **kwargs):
    return finish(SqueezeNet("1.1", **kwargs), pretrained, ctx)
