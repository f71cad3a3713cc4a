"""``gluon.contrib.cnn.DeformableConvolution``: Dai et al. 2017's
deformable convolution as a block.

Counterpart of ``mxnet_tpu/gluon/contrib/cnn.py`` (:18-95): an offset
branch, a plain ``Convolution`` to ``2 * kh * kw * num_deformable_group``
channels (its weight and bias initialised to zeros by default, so the
block starts as a regular convolution), feeds the registry's
``DeformableConvolution`` op with the main weights.  ``hybrid_forward``
runs on ``NDArray``s (``F = nd``) and on ``Symbol``s (``F = sym``), so
the block exports.  ``in_channels=0`` is inferred from the first input.
"""
from __future__ import annotations

from ...base import MXNetError
from ..block import HybridBlock

__all__ = ["DeformableConvolution"]


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


class DeformableConvolution(HybridBlock):
    def __init__(self, channels, kernel_size=(1, 1), strides=(1, 1),
                 padding=(0, 0), dilation=(1, 1), groups=1,
                 num_deformable_group=1, layout="NCHW", use_bias=True,
                 in_channels=0, activation=None, weight_initializer=None,
                 bias_initializer="zeros",
                 offset_weight_initializer="zeros",
                 offset_bias_initializer="zeros", offset_use_bias=True,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if layout != "NCHW":
            raise MXNetError("DeformableConvolution takes NCHW only")
        kernel = _pair(kernel_size)
        self._channels, self._kernel = channels, kernel
        self._act_type = activation
        self._offset_channels = 2 * kernel[0] * kernel[1] * \
            num_deformable_group
        common = {"kernel": kernel, "stride": _pair(strides),
                  "pad": _pair(padding), "dilate": _pair(dilation)}
        self._kwargs = dict(common, num_filter=channels, num_group=groups,
                            num_deformable_group=num_deformable_group,
                            no_bias=not use_bias)
        self._offset_kwargs = dict(common, num_filter=self._offset_channels,
                                   num_group=1, no_bias=not offset_use_bias)
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(channels, in_channels // groups) + kernel,
                init=weight_initializer, allow_deferred_init=True)
            self.offset_weight = self.params.get(
                "offset_weight",
                shape=(self._offset_channels, in_channels) + kernel,
                init=offset_weight_initializer, allow_deferred_init=True)
            self.bias = self.params.get(
                "bias", shape=(channels,), init=bias_initializer) \
                if use_bias else None
            self.offset_bias = self.params.get(
                "offset_bias", shape=(self._offset_channels,),
                init=offset_bias_initializer) if offset_use_bias else None

    def infer_shape(self, x, *args):
        cin = x.shape[1]
        self.weight._finish_deferred_init(
            (self._channels, cin // self._kwargs["num_group"]) + self._kernel)
        self.offset_weight._finish_deferred_init(
            (self._offset_channels, cin) + self._kernel)

    def hybrid_forward(self, F, x, weight, offset_weight, bias=None,
                       offset_bias=None):
        if offset_bias is None:
            offset = F.Convolution(x, offset_weight, **self._offset_kwargs)
        else:
            offset = F.Convolution(x, offset_weight, offset_bias,
                                   **self._offset_kwargs)
        if bias is None:
            out = F.DeformableConvolution(x, offset, weight, **self._kwargs)
        else:
            out = F.DeformableConvolution(x, offset, weight, bias,
                                          **self._kwargs)
        if self._act_type:
            out = F.Activation(out, act_type=self._act_type)
        return out
