"""int8 quantization: ``_contrib_quantize``, ``_contrib_quantize_v2``,
``_contrib_dequantize``, ``_contrib_requantize``,
``_contrib_quantized_fully_connected``, ``_contrib_quantized_conv`` and
``_contrib_quantized_pooling`` (with their short aliases).

Counterpart of ``mxnet_tpu/ndarray/ops_quantization.py``, with its
conventions: symmetric signed int8 with one scale a tensor, ``scale =
max(|min|, |max|) / 127``; the ranges travel beside the data as 0-d
(min, max) tensors (MXNet's three-tensor convention); an int32
accumulator's range is its real-value range, so ``dequantize`` divides
by the integer type's own maximum (127 for int8, 2**31 - 1 for int32).

The accumulators equal the JAX package's int32 bit for bit.  torch has no
int8 convolution on CUDA, so the products are taken in float64, where
every partial sum of int8 products is an integer below 2**53 and thus
exact in any order (ResNet-50's widest 3x3 convolution sums K = 4608
products of up to 127**2, past float32's 2**24), then cast to int32.

Rounding is ``jnp.round``'s, half to even (``torch.round``), of a true
quotient: every divisor is a 0-d tensor on the data's device, never a
Python number, which CUDA would turn into a multiply by the reciprocal
and so flip a tie now and then.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError
from .register import register_op

__all__ = ["scale_of", "quantize_tensor", "int_conv", "int_linear"]

_INT32_MAX = float(2 ** 31 - 1)


def _c(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a 0-d float32 tensor on ``like``'s device (a fill,
    which a CUDA graph can capture)."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def scale_of(mn: torch.Tensor, mx: torch.Tensor) -> torch.Tensor:
    """The int8 step of the range [mn, mx]: ``max(|mn|, |mx|) / 127``."""
    return torch.maximum(mn.abs(), mx.abs()) / _c(127.0, mn)


def quantize_tensor(data: torch.Tensor, scale: torch.Tensor,
                    lo: int = -127, hi: int = 127) -> torch.Tensor:
    """``clip(round(data / scale), lo, hi)`` as int8."""
    return torch.clamp(torch.round(data / scale), lo, hi).to(torch.int8)


def int_linear(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``x @ weight.T`` of int8 arrays with its exact int32 sums."""
    return torch.matmul(x.double(), weight.double().t()).to(torch.int32)


def int_conv(data: torch.Tensor, weight: torch.Tensor, stride, pad,
             dilate, groups: int) -> torch.Tensor:
    """The NCHW/OIHW convolution of int8 arrays with its exact int32
    sums."""
    return F.conv2d(data.double(), weight.double(), None, tuple(stride),
                    tuple(pad), tuple(dilate), int(groups)).to(torch.int32)


def _0d(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(())


def _int8_only(out_type):
    if out_type != "int8":
        raise MXNetError("only int8 quantization is supported")


def quantize_maker(out_type="int8"):
    _int8_only(out_type)

    def fn(data, min_range, max_range):
        q = quantize_tensor(data, scale_of(min_range, max_range))
        return q, _0d(min_range), _0d(max_range)
    return fn


def quantize_v2_maker(out_type="int8", min_calib_range=None,
                      max_calib_range=None):
    _int8_only(out_type)
    calibrated = min_calib_range is not None and max_calib_range is not None

    def fn(data):
        if calibrated:
            mn = torch.full((), float(min_calib_range), dtype=data.dtype,
                            device=data.device)
            mx = torch.full((), float(max_calib_range), dtype=data.dtype,
                            device=data.device)
        else:
            mn, mx = data.min(), data.max()
        return quantize_tensor(data, scale_of(mn, mx)), _0d(mn), _0d(mx)
    return fn


def dequantize_maker(out_type="float32"):
    def fn(data, min_range, max_range):
        top = 127.0 if data.dtype == torch.int8 else _INT32_MAX
        s = torch.maximum(min_range.abs(), max_range.abs()) / _c(top, data)
        return data.to(torch.float32) * s
    return fn


def requantize_maker(min_calib_range=None, max_calib_range=None,
                     out_type="int8"):
    _int8_only(out_type)
    calibrated = min_calib_range is not None and max_calib_range is not None

    def fn(data, min_range, max_range):
        s_in = torch.maximum(min_range.abs(), max_range.abs()) / \
            _c(_INT32_MAX, data)
        real = data.to(torch.float32) * s_in
        if calibrated:
            mn = _c(float(min_calib_range), data)
            mx = _c(float(max_calib_range), data)
        else:
            mn, mx = real.min(), real.max()
        q = quantize_tensor(real, scale_of(mn, mx))
        return q, _0d(mn), _0d(mx)
    return fn


def _bias32(bias, mnb, mxb, s_d, s_w) -> torch.Tensor:
    """An int8 bias with its own range, in the accumulator's domain."""
    b = bias.to(torch.float32) * scale_of(mnb, mxb)
    return torch.round(b / (s_d * s_w)).to(torch.int32)


def _accumulator_range(s_d, s_w):
    bound = s_d * s_w * _INT32_MAX
    return -_0d(bound), _0d(bound)


def quantized_fc_maker(num_hidden=None, no_bias=False, flatten=True):
    def fn(data, weight, *rest):
        # rest: [bias,] min_data, max_data, min_w, max_w[, min_b, max_b]
        bias = None if no_bias else rest[0]
        mnd, mxd, mnw, mxw = rest[:4] if no_bias else rest[1:5]
        x = data.reshape(data.shape[0], -1) if flatten else data
        out32 = int_linear(x, weight)
        s_d, s_w = scale_of(mnd, mxd), scale_of(mnw, mxw)
        if bias is not None:
            out32 = out32 + _bias32(bias, rest[5], rest[6], s_d, s_w)
        return (out32,) + _accumulator_range(s_d, s_w)
    return fn


def quantized_conv_maker(kernel=None, stride=(1, 1), pad=(0, 0),
                         dilate=(1, 1), num_filter=None, num_group=1,
                         no_bias=True, layout="NCHW"):
    if layout != "NCHW":
        raise MXNetError(f"quantized_conv: layout {layout!r} is not NCHW")

    def fn(data, weight, *rest):
        bias = None if no_bias else rest[0]
        mnd, mxd, mnw, mxw = rest[:4] if no_bias else rest[1:5]
        out32 = int_conv(data.to(torch.int8), weight.to(torch.int8),
                         stride, pad, dilate, num_group)
        s_d, s_w = scale_of(mnd, mxd), scale_of(mnw, mxw)
        if bias is not None:
            out32 = out32 + _bias32(bias, rest[5], rest[6], s_d,
                                    s_w).reshape(1, -1, 1, 1)
        return (out32,) + _accumulator_range(s_d, s_w)
    return fn


def quantized_pooling_maker(kernel=(2, 2), stride=None, pad=(0, 0),
                            pool_type="max"):
    k = tuple(kernel)
    st = tuple(stride) if stride else k
    p = tuple(pad)

    def fn(data, min_range, max_range):
        x = data.to(torch.float32)                   # int8 values, exact
        if pool_type == "max":
            out = F.max_pool2d(x, k, st, p).to(torch.int8)
        else:
            # the window's int32 sum (exact in float32 for int8 values),
            # then a true division by the window's size, rounded
            acc = F.avg_pool2d(x, k, st, p, count_include_pad=True,
                               divisor_override=1)
            out = quantize_tensor(acc, _c(float(k[0] * k[1]), x), -128, 127)
        return out, _0d(min_range), _0d(max_range)
    return fn


def _register():
    for name, maker in (
            ("quantize", quantize_maker), ("quantize_v2", quantize_v2_maker),
            ("dequantize", dequantize_maker),
            ("requantize", requantize_maker),
            ("quantized_fully_connected", quantized_fc_maker),
            ("quantized_conv", quantized_conv_maker),
            ("quantized_pooling", quantized_pooling_maker)):
        register_op("_contrib_" + name, maker, aliases=(name,),
                    differentiable=False)


_register()
