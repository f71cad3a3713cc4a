"""2-D convolution and pooling layers (NCHW data, OIHW weights).

Counterpart of ``mxnet_tpu/gluon/nn/conv_layers.py`` for the layers
ResNet uses: ``Conv2D``, ``MaxPool2D``, ``AvgPool2D``,
``GlobalAvgPool2D``.  The JAX package computes them in XLA outside any
Pallas kernel, so here they are ``F.conv2d`` and torch's pooling calls.
``in_channels`` must be given (no deferred shape inference).  Under
``contrib.amp`` Conv2D ("Convolution") casts its input, weight and bias to
the target dtype.

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

__all__ = ["Conv2D", "MaxPool2D", "AvgPool2D", "GlobalAvgPool2D"]


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _nchw(layout):
    if layout != "NCHW":
        raise MXNetError(f"layout {layout!r}: the port takes NCHW only")


class Conv2D(HybridBlock):
    """``act(conv2d(x, W) + b)``, weight ``(channels, in_channels //
    groups, kh, kw)``."""

    def __init__(self, channels, kernel_size, strides=(1, 1),
                 padding=(0, 0), dilation=(1, 1), groups=1, layout="NCHW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        _nchw(layout)
        self._kw = dict(stride=_pair(strides), padding=_pair(padding),
                        dilation=_pair(dilation), groups=groups)
        self._act = _activation(activation) if activation else None
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(channels, in_channels // groups)
                + _pair(kernel_size), init=weight_initializer)
            self.bias = self.params.get(
                "bias", shape=(channels,), init=bias_initializer) \
                if use_bias else None

    def forward(self, x):
        # Convolution: LP16 under AMP
        x, w, b = _amp.cast("Convolution", x, self.weight.data(),
                            None if self.bias is None else self.bias.data())
        out = F.conv2d(x, w, b, **self._kw)
        return out if self._act is None else self._act(out)


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
