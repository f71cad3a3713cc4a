"""Convolution and pooling layers over 1, 2 or 3 spatial axes, channels
first (NCW, NCHW, NCDHW data; OI... weights).

Counterpart of ``mxnet_tpu/gluon/nn/conv_layers.py``: ``Conv1D``/``2D``/
``3D``, their transposes, the max and average pools, and the global max
and average pools.  The JAX package computes them in XLA outside any
Pallas kernel, so here they are torch's convolutions and the ``Pooling``
op's code (``ndarray/ops_nn.py``).  ``in_channels=0`` (the default) is
inferred from the first input (``infer_shape``).  Weights: ``(channels,
in_channels // groups, *kernel)`` for a convolution, MXNet's
``(in_channels, channels // groups, *kernel)`` for a transpose
(``Deconvolution``: output size ``(in - 1) * stride - 2 * padding +
dilation * (k - 1) + 1 + output_padding``, torch's arithmetic and
MXNet's).  Under ``contrib.amp`` both ("Convolution", "Deconvolution")
cast their input, weight and bias to the target dtype.

Pooling keeps MXNet's conventions: padding is implicit ``-inf`` for max
and zeros for average; ``ceil_mode=True`` is the ``full`` convention (the
last partial window counts); an average divides by the whole window
unless ``count_include_pad=False``, which divides by the window's cells
inside the input.  Channels-last layouts (NHWC) raise ``MXNetError``.
"""
from __future__ import annotations

import torch.nn.functional as F

from ...base import MXNetError
from ...contrib.amp import amp as _amp
from ...ndarray.ops_nn import pooling_maker
from ..block import HybridBlock
from .basic_layers import _activation

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "AvgPool1D", "AvgPool2D", "AvgPool3D",
           "GlobalMaxPool1D", "GlobalMaxPool2D", "GlobalMaxPool3D",
           "GlobalAvgPool1D", "GlobalAvgPool2D", "GlobalAvgPool3D"]

_LAYOUTS = {1: "NCW", 2: "NCHW", 3: "NCDHW"}
_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_DECONV = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def _tuple(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


def _channels_first(layout, n):
    if layout != _LAYOUTS[n]:
        raise MXNetError(f"layout {layout!r}: the port takes "
                         f"{_LAYOUTS[n]} only")


class _Conv(HybridBlock):
    """A convolution (``op`` "Convolution") or its transpose
    ("Deconvolution") over ``len(kernel_size)`` axes, with a deferred
    ``in_channels``."""

    def __init__(self, op, channels, kernel_size, strides, padding,
                 dilation, groups, layout, activation, use_bias,
                 weight_initializer, bias_initializer, in_channels,
                 prefix=None, params=None, **extra):
        super().__init__(prefix=prefix, params=params)
        n = len(kernel_size)
        _channels_first(layout, n)
        self._op = op
        self._channels, self._groups = channels, groups
        self._kernel = tuple(kernel_size)
        self._fn = (_CONV if op == "Convolution" else _DECONV)[n]
        self._kw = dict(stride=_tuple(strides, n), padding=_tuple(padding, n),
                        dilation=_tuple(dilation, n), groups=groups,
                        **{k: _tuple(v, n) for k, v in extra.items()})
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
        out = self._fn(x, w, b, **self._kw)
        return out if self._act is None else self._act(out)


def _conv(n, transpose):
    """The Conv{n}D (or Conv{n}DTranspose) class: MXNet's signature with
    its defaults for ``n`` axes."""
    one, zero = (1,) * n, (0,) * n
    layout = _LAYOUTS[n]
    if not transpose:
        def init(self, channels, kernel_size, strides=one, padding=zero,
                 dilation=one, groups=1, layout=layout, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, prefix=None,
                 params=None):
            _Conv.__init__(self, "Convolution", channels,
                           _tuple(kernel_size, n), strides, padding,
                           dilation, groups, layout, activation, use_bias,
                           weight_initializer, bias_initializer,
                           in_channels, prefix=prefix, params=params)
        doc = (f"``act(conv{n}d(x, W) + b)``, weight ``(channels, "
               f"in_channels // groups, *kernel)``.")
    else:
        def init(self, channels, kernel_size, strides=one, padding=zero,
                 output_padding=zero, dilation=one, groups=1,
                 layout=layout, activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, prefix=None, params=None):
            _Conv.__init__(self, "Deconvolution", channels,
                           _tuple(kernel_size, n), strides, padding,
                           dilation, groups, layout, activation, use_bias,
                           weight_initializer, bias_initializer,
                           in_channels, prefix=prefix, params=params,
                           output_padding=output_padding)
        doc = (f"``act(conv_transpose{n}d(x, W) + b)`` (MXNet's "
               f"``Deconvolution``), weight ``(in_channels, channels // "
               f"groups, *kernel)``.")
    name = f"Conv{n}D" + ("Transpose" if transpose else "")
    return type(name, (_Conv,), {"__init__": init, "__doc__": doc,
                                 "__module__": __name__})


Conv1D, Conv2D, Conv3D = (_conv(n, False) for n in (1, 2, 3))
Conv1DTranspose, Conv2DTranspose, Conv3DTranspose = (
    _conv(n, True) for n in (1, 2, 3))


class _Pooling(HybridBlock):
    """A pooling layer: the ``Pooling`` op's code with the layer's
    parameters."""

    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, count_include_pad=True, layout="NCHW",
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        n = len(pool_size)
        _channels_first(layout, n)
        self._fn = pooling_maker(
            kernel=pool_size,
            stride=_tuple(strides, n) if strides is not None else pool_size,
            pad=_tuple(padding, n), pool_type=pool_type,
            global_pool=global_pool,
            pooling_convention="full" if ceil_mode else "valid",
            count_include_pad=count_include_pad)

    def forward(self, x):
        return self._fn(x)


def _pool(n, pool_type):
    default = 2 if n == 1 else (2,) * n
    layout = _LAYOUTS[n]
    if pool_type == "max":
        def init(self, pool_size=default, strides=None, padding=0,
                 layout=layout, ceil_mode=False, prefix=None, params=None):
            _Pooling.__init__(self, _tuple(pool_size, n), strides, padding,
                              ceil_mode, False, "max", layout=layout,
                              prefix=prefix, params=params)
    else:
        def init(self, pool_size=default, strides=None, padding=0,
                 layout=layout, ceil_mode=False, count_include_pad=True,
                 prefix=None, params=None):
            _Pooling.__init__(self, _tuple(pool_size, n), strides, padding,
                              ceil_mode, False, "avg", count_include_pad,
                              layout=layout, prefix=prefix, params=params)
    name = f"{pool_type.capitalize()}Pool{n}D"
    return type(name, (_Pooling,), {
        "__init__": init, "__module__": __name__,
        "__doc__": f"{pool_type} pooling over {n} axes (strides default "
                   f"to the pool size)."})


def _global_pool(n, pool_type):
    layout = _LAYOUTS[n]

    def init(self, layout=layout, prefix=None, params=None):
        _Pooling.__init__(self, (1,) * n, (1,) * n, (0,) * n, False, True,
                          pool_type, layout=layout, prefix=prefix,
                          params=params)
    name = f"Global{pool_type.capitalize()}Pool{n}D"
    return type(name, (_Pooling,), {
        "__init__": init, "__module__": __name__,
        "__doc__": f"{pool_type} over the {n} spatial axes, keeping them "
                   f"with size 1."})


MaxPool1D, MaxPool2D, MaxPool3D = (_pool(n, "max") for n in (1, 2, 3))
AvgPool1D, AvgPool2D, AvgPool3D = (_pool(n, "avg") for n in (1, 2, 3))
GlobalMaxPool1D, GlobalMaxPool2D, GlobalMaxPool3D = (
    _global_pool(n, "max") for n in (1, 2, 3))
GlobalAvgPool1D, GlobalAvgPool2D, GlobalAvgPool3D = (
    _global_pool(n, "avg") for n in (1, 2, 3))
