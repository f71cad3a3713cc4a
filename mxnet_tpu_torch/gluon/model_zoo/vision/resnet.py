"""ResNet v1 (He et al. 2015, post-activation; BASELINE config #2) and v2
(He et al. 2016, pre-activation) at 18, 34, 50, 101 and 152 layers.

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision/resnet.py``: the same
blocks, stage widths, stride placement and creation order, so
``collect_params()`` names match the JAX package's and
``load_reference_params`` carries weights and BatchNorm running statistics
across.  The JAX blocks leave ``in_channels`` to deferred shape inference;
here every layer is given its channel count.  Data is NCHW (``layout``
"NHWC" raises).  ``pretrained=True`` raises, as the JAX package's
``get_resnet`` does (no download); ``ctx`` initializes the net there.
"""
from __future__ import annotations

from ....base import MXNetError
from ... import nn
from ...block import HybridBlock
from ._common import check_layout, finish

__all__ = ["ResNetV1", "ResNetV2", "BasicBlockV1", "BasicBlockV2",
           "BottleneckV1", "BottleneckV2", "resnet18_v1", "resnet34_v1",
           "resnet50_v1", "resnet101_v1", "resnet152_v1", "resnet18_v2",
           "resnet34_v2", "resnet50_v2", "resnet101_v2", "resnet152_v2",
           "get_resnet"]


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


class BasicBlockV2(HybridBlock):
    """Pre-activation basic block: BN, relu, 3x3 conv, BN, relu, 3x3
    conv; the shortcut (a 1x1 conv with ``downsample``) taken after the
    first BN and relu."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self.bn1 = nn.BatchNorm(in_channels=in_channels)
        self.conv1 = _conv3x3(channels, stride, in_channels)
        self.bn2 = nn.BatchNorm(in_channels=channels)
        self.conv2 = _conv3x3(channels, 1, channels)
        self.downsample = nn.Conv2D(channels, 1, stride, use_bias=False,
                                    in_channels=in_channels) \
            if downsample else None

    def forward(self, x):
        residual = x
        x = self.bn1(x).relu()
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv2(self.bn2(self.conv1(x)).relu())
        return x + residual


class BottleneckV2(HybridBlock):
    """Pre-activation bottleneck: BN, relu, 1x1 conv, BN, relu, 3x3 conv
    (the stride), BN, relu, 1x1 conv; the shortcut as in
    :class:`BasicBlockV2`."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        mid = channels // 4
        self.bn1 = nn.BatchNorm(in_channels=in_channels)
        self.conv1 = nn.Conv2D(mid, kernel_size=1, strides=1,
                               use_bias=False, in_channels=in_channels)
        self.bn2 = nn.BatchNorm(in_channels=mid)
        self.conv2 = _conv3x3(mid, stride, mid)
        self.bn3 = nn.BatchNorm(in_channels=mid)
        self.conv3 = nn.Conv2D(channels, kernel_size=1, strides=1,
                               use_bias=False, in_channels=mid)
        self.downsample = nn.Conv2D(channels, 1, stride, use_bias=False,
                                    in_channels=in_channels) \
            if downsample else None

    def forward(self, x):
        residual = x
        x = self.bn1(x).relu()
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.bn2(self.conv1(x)).relu()
        x = self.bn3(self.conv2(x)).relu()
        return self.conv3(x) + residual


def _make_layer(block, layers, channels, stride, stage_index, in_channels):
    layer = nn.HybridSequential(prefix=f"stage{stage_index}_")
    with layer.name_scope():
        layer.add(block(channels, stride, channels != in_channels,
                        in_channels=in_channels, prefix=""))
        for _ in range(layers - 1):
            layer.add(block(channels, 1, False, in_channels=channels,
                            prefix=""))
    return layer


def _stem(features, channels, thumbnail, in_channels):
    if thumbnail:
        features.add(_conv3x3(channels, 1, in_channels))
    else:
        features.add(nn.Conv2D(channels, 7, 2, 3, use_bias=False,
                               in_channels=in_channels))
        features.add(nn.BatchNorm(in_channels=channels))
        features.add(nn.Activation("relu"))
        features.add(nn.MaxPool2D(3, 2, 1))


def _check_spec(layers, channels):
    if len(layers) != len(channels) - 1:
        raise MXNetError(f"{len(layers)} stages need {len(layers) + 1} "
                         f"channel counts, got {len(channels)}")


class ResNetV1(HybridBlock):
    """Stem (7x7/2 conv, BN, relu, 3x3/2 max pool; a 3x3/1 conv when
    ``thumbnail``), ``len(layers)`` stages of ``block``, global average
    pool, Dense ``classes``."""

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, in_channels=3, layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        _check_spec(layers, channels)
        check_layout(layout)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            _stem(self.features, channels[0], thumbnail, in_channels)
            for i, num_layer in enumerate(layers):
                stride = 1 if i == 0 else 2
                self.features.add(_make_layer(
                    block, num_layer, channels[i + 1], stride, i + 1,
                    in_channels=channels[i]))
            self.features.add(nn.GlobalAvgPool2D())
            self.output = nn.Dense(classes, in_units=channels[-1])

    def forward(self, x):
        return self.output(self.features(x))


class ResNetV2(HybridBlock):
    """A BN of the input (no scale, no shift), the v1 stem, the stages of
    pre-activation ``block``s, BN and relu, global average pool,
    flatten, Dense ``classes``."""

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, in_channels=3, layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        _check_spec(layers, channels)
        check_layout(layout)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(nn.BatchNorm(scale=False, center=False,
                                           in_channels=in_channels))
            _stem(self.features, channels[0], thumbnail, in_channels)
            width = channels[0]
            for i, num_layer in enumerate(layers):
                stride = 1 if i == 0 else 2
                self.features.add(_make_layer(
                    block, num_layer, channels[i + 1], stride, i + 1,
                    in_channels=width))
                width = channels[i + 1]
            self.features.add(nn.BatchNorm(in_channels=width))
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.GlobalAvgPool2D())
            self.features.add(nn.Flatten())
            self.output = nn.Dense(classes, in_units=width)

    def forward(self, x):
        return self.output(self.features(x))


resnet_spec = {
    18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048]),
}
_VERSIONS = {1: (ResNetV1, {"basic_block": BasicBlockV1,
                            "bottle_neck": BottleneckV1}),
             2: (ResNetV2, {"basic_block": BasicBlockV2,
                            "bottle_neck": BottleneckV2})}


def get_resnet(version, num_layers, pretrained=False, ctx=None, **kwargs):
    """ResNet ``version`` (1 or 2) of ``num_layers`` layers."""
    if num_layers not in resnet_spec:
        raise MXNetError(f"no resnet with {num_layers} layers; choose from "
                         f"{sorted(resnet_spec)}")
    if version not in _VERSIONS:
        raise MXNetError("resnet version must be 1 or 2")
    block_type, layers, channels = resnet_spec[num_layers]
    net_cls, blocks = _VERSIONS[version]
    return finish(net_cls(blocks[block_type], layers, channels, **kwargs),
                  pretrained, ctx)


def _constructor(version, num_layers):
    def make(**kwargs):
        return get_resnet(version, num_layers, **kwargs)
    make.__name__ = make.__qualname__ = f"resnet{num_layers}_v{version}"
    make.__doc__ = f"ResNet-{num_layers} v{version}."
    return make


resnet18_v1, resnet34_v1, resnet50_v1, resnet101_v1, resnet152_v1 = (
    _constructor(1, n) for n in (18, 34, 50, 101, 152))
resnet18_v2, resnet34_v2, resnet50_v2, resnet101_v2, resnet152_v2 = (
    _constructor(2, n) for n in (18, 34, 50, 101, 152))
