"""ResNet v1 (He et al. 2015, post-activation): BASELINE config #2.

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision/resnet.py`` (v1 only):
the same blocks, stage widths, stride placement and creation order, so
``collect_params()`` names match the JAX package's and
``load_reference_params`` carries weights and BatchNorm running statistics
across.  The JAX blocks leave ``in_channels`` to deferred shape inference;
here every layer is given its channel count.  Data is NCHW.
"""
from __future__ import annotations

from ....base import MXNetError
from ... import nn
from ...block import HybridBlock

__all__ = ["ResNetV1", "BasicBlockV1", "BottleneckV1", "get_resnet",
           "resnet18_v1", "resnet50_v1"]


def _conv3x3(channels, stride, in_channels):
    return nn.Conv2D(channels, kernel_size=3, strides=stride, padding=1,
                     use_bias=False, in_channels=in_channels)


def _downsample(channels, stride, in_channels):
    seq = nn.HybridSequential(prefix="")
    seq.add(nn.Conv2D(channels, kernel_size=1, strides=stride,
                      use_bias=False, in_channels=in_channels))
    seq.add(nn.BatchNorm(in_channels=channels))
    return seq


class BasicBlockV1(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self.body = nn.HybridSequential(prefix="")
        self.body.add(_conv3x3(channels, stride, in_channels))
        self.body.add(nn.BatchNorm(in_channels=channels))
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv3x3(channels, 1, channels))
        self.body.add(nn.BatchNorm(in_channels=channels))
        self.downsample = _downsample(channels, stride, in_channels) \
            if downsample else None

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        return (residual + self.body(x)).relu()


class BottleneckV1(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        mid = channels // 4
        self.body = nn.HybridSequential(prefix="")
        self.body.add(nn.Conv2D(mid, kernel_size=1, strides=stride,
                                use_bias=False, in_channels=in_channels))
        self.body.add(nn.BatchNorm(in_channels=mid))
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv3x3(mid, 1, mid))
        self.body.add(nn.BatchNorm(in_channels=mid))
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(channels, kernel_size=1, strides=1,
                                use_bias=False, in_channels=mid))
        self.body.add(nn.BatchNorm(in_channels=channels))
        self.downsample = _downsample(channels, stride, in_channels) \
            if downsample else None

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        return (self.body(x) + residual).relu()


class ResNetV1(HybridBlock):
    """Stem (7x7/2 conv, BN, relu, 3x3/2 max pool; a 3x3/1 conv when
    ``thumbnail``), ``len(layers)`` stages of ``block``, global average
    pool, Dense ``classes``."""

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, in_channels=3, **kwargs):
        super().__init__(**kwargs)
        if len(layers) != len(channels) - 1:
            raise MXNetError(f"{len(layers)} stages need "
                             f"{len(layers) + 1} channel counts, got "
                             f"{len(channels)}")
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            if thumbnail:
                self.features.add(_conv3x3(channels[0], 1, in_channels))
            else:
                self.features.add(nn.Conv2D(channels[0], 7, 2, 3,
                                            use_bias=False,
                                            in_channels=in_channels))
                self.features.add(nn.BatchNorm(in_channels=channels[0]))
                self.features.add(nn.Activation("relu"))
                self.features.add(nn.MaxPool2D(3, 2, 1))
            for i, num_layer in enumerate(layers):
                stride = 1 if i == 0 else 2
                self.features.add(self._make_layer(
                    block, num_layer, channels[i + 1], stride, i + 1,
                    in_channels=channels[i]))
            self.features.add(nn.GlobalAvgPool2D())
            self.output = nn.Dense(classes, in_units=channels[-1])

    @staticmethod
    def _make_layer(block, layers, channels, stride, stage_index,
                    in_channels):
        layer = nn.HybridSequential(prefix=f"stage{stage_index}_")
        with layer.name_scope():
            layer.add(block(channels, stride, channels != in_channels,
                            in_channels=in_channels, prefix=""))
            for _ in range(layers - 1):
                layer.add(block(channels, 1, False, in_channels=channels,
                                prefix=""))
        return layer

    def forward(self, x):
        return self.output(self.features(x))


resnet_spec = {
    18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048]),
}
_BLOCKS = {"basic_block": BasicBlockV1, "bottle_neck": BottleneckV1}


def get_resnet(version, num_layers, **kwargs):
    """ResNet ``version`` (1 only here) of ``num_layers`` layers, random
    weights once initialized (no pretrained download)."""
    if version != 1:
        raise MXNetError("the port has ResNet v1 only")
    if num_layers not in resnet_spec:
        raise MXNetError(f"no resnet with {num_layers} layers; choose from "
                         f"{sorted(resnet_spec)}")
    block_type, layers, channels = resnet_spec[num_layers]
    return ResNetV1(_BLOCKS[block_type], layers, channels, **kwargs)


def resnet18_v1(**kwargs):
    return get_resnet(1, 18, **kwargs)


def resnet50_v1(**kwargs):
    return get_resnet(1, 50, **kwargs)
