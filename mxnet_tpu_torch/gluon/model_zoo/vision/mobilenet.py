"""MobileNet v1 (Howard et al. 2017) and v2 (Sandler et al. 2018) at
width multipliers 1.0, 0.75, 0.5 and 0.25, 224 x 224 input.

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision/mobilenet.py``: the
depthwise convolutions are grouped convolutions, v2's ReLU6 is a
``HybridLambda`` of ``F.clip`` as there (``mobilenet.py:21-22``), and the
creation order and parameter names are the JAX package's.
"""
from __future__ import annotations

from ... import nn
from ...block import HybridBlock
from ._common import finish

__all__ = ["MobileNet", "MobileNetV2", "mobilenet1_0", "mobilenet0_75",
           "mobilenet0_5", "mobilenet0_25", "mobilenet_v2_1_0",
           "mobilenet_v2_0_75", "mobilenet_v2_0_5", "mobilenet_v2_0_25"]


def _add_conv(out, channels=1, kernel=1, stride=1, pad=0, num_group=1,
              active=True, relu6=False):
    out.add(nn.Conv2D(channels, kernel, stride, pad, groups=num_group,
                      use_bias=False))
    out.add(nn.BatchNorm(scale=True))
    if active:
        if relu6:
            out.add(nn.HybridLambda(
                lambda F, x: F.clip(x, a_min=0.0, a_max=6.0)))
        else:
            out.add(nn.Activation("relu"))


def _add_conv_dw(out, dw_channels, channels, stride, relu6=False):
    _add_conv(out, dw_channels, kernel=3, stride=stride, pad=1,
              num_group=dw_channels, relu6=relu6)
    _add_conv(out, channels, relu6=relu6)


class LinearBottleneck(HybridBlock):
    """v2's inverted residual: 1x1 expansion by ``t``, 3x3 depthwise
    (the stride), 1x1 linear projection; the input added back when the
    stride is 1 and the widths agree."""

    def __init__(self, in_channels, channels, t, stride, **kwargs):
        super().__init__(**kwargs)
        self.use_shortcut = stride == 1 and in_channels == channels
        with self.name_scope():
            self.out = nn.HybridSequential()
            _add_conv(self.out, in_channels * t, relu6=True)
            _add_conv(self.out, in_channels * t, kernel=3, stride=stride,
                      pad=1, num_group=in_channels * t, relu6=True)
            _add_conv(self.out, channels, active=False, relu6=True)

    def forward(self, x):
        out = self.out(x)
        return out + x if self.use_shortcut else out


class MobileNet(HybridBlock):
    def __init__(self, multiplier=1.0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            _add_conv(self.features, int(32 * multiplier), kernel=3,
                      stride=2, pad=1)
            dw_channels = [int(x * multiplier) for x in
                           [32, 64] + [128] * 2 + [256] * 2 + [512] * 6 +
                           [1024]]
            channels = [int(x * multiplier) for x in
                        [64] + [128] * 2 + [256] * 2 + [512] * 6 +
                        [1024] * 2]
            strides = [1, 2, 1, 2, 1, 2] + [1] * 5 + [2, 1]
            for dwc, c, s in zip(dw_channels, channels, strides):
                _add_conv_dw(self.features, dwc, c, s)
            self.features.add(nn.GlobalAvgPool2D())
            self.features.add(nn.Flatten())
            self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


class MobileNetV2(HybridBlock):
    def __init__(self, multiplier=1.0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="features_")
            with self.features.name_scope():
                _add_conv(self.features, int(32 * multiplier), kernel=3,
                          stride=2, pad=1, relu6=True)
                in_channels_group = [int(x * multiplier) for x in
                                     [32] + [16] + [24] * 2 + [32] * 3 +
                                     [64] * 4 + [96] * 3 + [160] * 3]
                channels_group = [int(x * multiplier) for x in
                                  [16] + [24] * 2 + [32] * 3 + [64] * 4 +
                                  [96] * 3 + [160] * 3 + [320]]
                ts = [1] + [6] * 16
                strides = [1, 2] + [1, 2] + [1] * 2 + [2] + [1] * 6 + \
                    [2] + [1] * 3
                for in_c, c, t, s in zip(in_channels_group, channels_group,
                                         ts, strides):
                    self.features.add(LinearBottleneck(
                        in_channels=in_c, channels=c, t=t, stride=s))
                last = int(1280 * multiplier) if multiplier > 1.0 else 1280
                _add_conv(self.features, last, relu6=True)
                self.features.add(nn.GlobalAvgPool2D())
            self.output = nn.HybridSequential(prefix="output_")
            with self.output.name_scope():
                self.output.add(nn.Conv2D(classes, 1, use_bias=False,
                                          prefix="pred_"),
                                nn.Flatten())

    def forward(self, x):
        return self.output(self.features(x))


def _constructor(cls, multiplier, name):
    def make(pretrained=False, ctx=None, **kwargs):
        return finish(cls(multiplier, **kwargs), pretrained, ctx)
    make.__name__ = make.__qualname__ = name
    make.__doc__ = f"{cls.__name__} at width multiplier {multiplier}."
    return make


mobilenet1_0, mobilenet0_75, mobilenet0_5, mobilenet0_25 = (
    _constructor(MobileNet, m, f"mobilenet{str(m).replace('.', '_')}")
    for m in (1.0, 0.75, 0.5, 0.25))
mobilenet_v2_1_0, mobilenet_v2_0_75, mobilenet_v2_0_5, mobilenet_v2_0_25 = (
    _constructor(MobileNetV2, m,
                 f"mobilenet_v2_{str(m).replace('.', '_')}")
    for m in (1.0, 0.75, 0.5, 0.25))
