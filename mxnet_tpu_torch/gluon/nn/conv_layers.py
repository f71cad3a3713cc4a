"""2-D convolution and pooling layers (NCHW data, OIHW weights).

Counterpart of ``mxnet_tpu/gluon/nn/conv_layers.py`` for the layers
ResNet, SSD and Mask-RCNN use: ``Conv2D``, ``Conv2DTranspose``,
``MaxPool2D``, ``AvgPool2D``, ``GlobalAvgPool2D``.  The JAX package
computes them in XLA outside any Pallas kernel, so here they are
``F.conv2d``, ``F.conv_transpose2d`` and torch's pooling calls.
``in_channels=0`` (the default) is inferred from the first input
(``infer_shape``).  Weights: ``(channels, in_channels // groups, kh, kw)``
for Conv2D, MXNet's ``(in_channels, channels // groups, kh, kw)`` for
Conv2DTranspose (``Deconvolution``: output size ``(in - 1) * stride -
2 * padding + dilation * (k - 1) + 1 + output_padding``, torch's
arithmetic and MXNet's).  Under ``contrib.amp`` both ("Convolution",
"Deconvolution") cast their input, weight and bias to the target dtype.

Pooling keeps MXNet's default conventions: padding is implicit ``-inf``
for max and zeros for average, and the average divides by the window size
(``count_include_pad=True``).  ``ceil_mode=True`` (MXNet's ``full``
convention), ``count_include_pad=False`` and other layouts (NHWC) come
with a model that uses them; asked for now, they raise ``MXNetError``.
"""
from __future__ import annotations

import torch.nn.functional as F

from ...base import MXNetError
from ...contrib.amp import amp as _amp
from ..block import HybridBlock
from .basic_layers import _activation

__all__ = ["Conv2D", "Conv2DTranspose", "MaxPool2D", "AvgPool2D", "GlobalAvgPool2D"]


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _nchw(layout):
    if layout != "NCHW":
        raise MXNetError(f"layout {layout!r}: the port takes NCHW only")


class _Conv(HybridBlock):
    """A 2-D convolution (``op`` "Convolution") or its transpose
    ("Deconvolution") with a deferred ``in_channels``."""

    def __init__(self, op, channels, kernel_size, strides, padding,
                 dilation, groups, layout, activation, use_bias,
                 weight_initializer, bias_initializer, in_channels,
                 prefix=None, params=None, **extra):
        super().__init__(prefix=prefix, params=params)
        _nchw(layout)
        self._op = op
        self._channels, self._groups = channels, groups
        self._kernel = _pair(kernel_size)
        self._kw = dict(stride=_pair(strides), padding=_pair(padding),
                        dilation=_pair(dilation), groups=groups, **extra)
        self._act = _activation(activation) if activation else None
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=self._weight_shape(in_channels),
                init=weight_initializer, allow_deferred_init=True)
            self.bias = self.params.get(
                "bias", shape=(channels,), init=bias_initializer) \
                if use_bias else None

    def _weight_shape(self, cin):
        if self._op == "Convolution":
            return (self._channels, cin // self._groups) + self._kernel
        return (cin, self._channels // self._groups) + self._kernel

    def infer_shape(self, x, *args):
        self.weight._finish_deferred_init(self._weight_shape(x.shape[1]))

    def forward(self, x):
        # Convolution / Deconvolution: LP16 under AMP
        x, w, b = _amp.cast(self._op, x, self.weight.data(),
                            None if self.bias is None else self.bias.data())
        conv = F.conv2d if self._op == "Convolution" else F.conv_transpose2d
        out = conv(x, w, b, **self._kw)
        return out if self._act is None else self._act(out)


class Conv2D(_Conv):
    """``act(conv2d(x, W) + b)``, weight ``(channels, in_channels //
    groups, kh, kw)``."""

    def __init__(self, channels, kernel_size, strides=(1, 1),
                 padding=(0, 0), dilation=(1, 1), groups=1, layout="NCHW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, prefix=None,
                 params=None):
        super().__init__("Convolution", channels, kernel_size, strides,
                         padding, dilation, groups, layout, activation,
                         use_bias, weight_initializer, bias_initializer,
                         in_channels, prefix=prefix, params=params)


class Conv2DTranspose(_Conv):
    """``act(conv_transpose2d(x, W) + b)`` (MXNet's ``Deconvolution``),
    weight ``(in_channels, channels // groups, kh, kw)``."""

    def __init__(self, channels, kernel_size, strides=(1, 1),
                 padding=(0, 0), output_padding=(0, 0), dilation=(1, 1),
                 groups=1, layout="NCHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, prefix=None, params=None):
        super().__init__("Deconvolution", channels, kernel_size, strides,
                         padding, dilation, groups, layout, activation,
                         use_bias, weight_initializer, bias_initializer,
                         in_channels, prefix=prefix, params=params,
                         output_padding=_pair(output_padding))


class _Pool2D(HybridBlock):
    def __init__(self, pool_size, strides, padding, ceil_mode, pool_type,
                 count_include_pad=True, layout="NCHW", prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        _nchw(layout)
        if ceil_mode or not count_include_pad:
            raise MXNetError("pooling: ceil_mode=True and count_include_pad="
                             "False are not ported yet")
        self._k = _pair(pool_size)
        self._s = _pair(strides) if strides is not None else self._k
        self._p = _pair(padding)
        self._type = pool_type

    def forward(self, x):
        if self._type == "max":
            return F.max_pool2d(x, self._k, self._s, self._p)
        return F.avg_pool2d(x, self._k, self._s, self._p)


class MaxPool2D(_Pool2D):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        super().__init__(pool_size, strides, padding, ceil_mode, "max",
                         layout=layout, **kwargs)


class AvgPool2D(_Pool2D):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(pool_size, strides, padding, ceil_mode, "avg",
                         count_include_pad, layout=layout, **kwargs)


class GlobalAvgPool2D(HybridBlock):
    """Mean over H and W, keeping them: ``(N, C, 1, 1)``."""

    def __init__(self, layout="NCHW", prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        _nchw(layout)

    def forward(self, x):
        return x.mean(dim=(2, 3), keepdim=True)
