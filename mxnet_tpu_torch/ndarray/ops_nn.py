"""Neural-network operators: ``FullyConnected``, ``Convolution``,
``Pooling``, ``Activation``, ``softmax``/``log_softmax``,
``SoftmaxOutput``, ``BatchNorm`` and ``Dropout``.

Counterpart of ``mxnet_tpu/ndarray/ops_nn.py``: FullyConnected :24-33
(``flatten``, ``no_bias``), Convolution :60-84 (NCW/NCHW/NCDHW data, OI..
weights), Pooling :118-187 (max/avg/sum, ``global_pool``,
``pooling_convention`` valid/full, ``count_include_pad``), Activation
:191-200, softmax :226-242, log_softmax :244-250, SoftmaxOutput :262-303,
BatchNorm :306-331 and Dropout :437-448.  MXNet's conventions hold:

- ``SoftmaxOutput(data, label)`` is softmax over axis 1 forward; its
  backward ignores the head gradient and hands ``data`` (p -
  onehot(label)) * ``grad_scale`` (``use_ignore`` zeroes the rows of
  ``ignore_label``; ``normalization`` "batch" divides by the batch,
  "valid" by the count of labels not ignored);
- ``BatchNorm(data, gamma, beta, moving_mean, moving_var)`` normalises
  by the batch's statistics (biased variance, in float32) in training
  mode (``autograd.is_training()``, unless ``use_global_stats``) and
  updates ``moving_mean``/``moving_var`` in place (``momentum`` * old +
  (1 - ``momentum``) * batch), as MXNet does; otherwise it uses the
  moving statistics.  It returns ``out`` (and the batch mean and
  variance with ``output_mean_var``).  The JAX op returns ``(out,
  new_mean, new_var)`` and mutates nothing;
- ``Dropout`` is the identity outside training mode (unless
  ``mode="always"``); its mask comes from the device's generator
  (``mx.random``).

``Pooling``'s "full" convention pads the high side so the last partial
window counts, and an average over a padded window divides by the whole
window (``count_include_pad``), as the JAX op's explicit padding does.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .. import autograd
from .. import random as _random
from ..base import MXNetError, torch_dtype
from ..contrib.amp import amp as _amp
from .register import register_op


def fully_connected_maker(num_hidden=None, no_bias=False, flatten=True):
    def fn(x, w, b=None):
        if flatten and x.dim() > 2:
            x = x.reshape(x.shape[0], -1)
        return F.linear(x, w, None if no_bias else b)
    return fn


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _layout_check(layout, nd: int, op: str) -> None:
    if layout not in (None, {1: "NCW", 2: "NCHW", 3: "NCDHW"}[nd]):
        raise MXNetError(f"{op}: layout {layout!r} is not ported "
                         f"(channels first only)")


def convolution_maker(kernel=(), stride=None, dilate=None, pad=None,
                      num_filter=None, num_group=1, no_bias=False,
                      layout=None, workspace=None, cudnn_tune=None,
                      cudnn_off=None):
    nd = len(kernel)
    _layout_check(layout, nd, "Convolution")
    conv = _CONV[nd]
    stride_ = tuple(stride) if stride else (1,) * nd
    dilate_ = tuple(dilate) if dilate else (1,) * nd
    pad_ = tuple(pad) if pad else (0,) * nd

    def fn(x, w, b=None):
        return conv(x, w, None if no_bias else b, stride_, pad_, dilate_,
                    num_group)
    return fn


_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


def pooling_maker(kernel=(), pool_type="max", stride=None, pad=None,
                  global_pool=False, pooling_convention="valid",
                  count_include_pad=True, cudnn_off=None, p_value=2,
                  layout=None):
    if pool_type not in ("max", "avg", "sum"):
        raise MXNetError(f"Pooling: pool_type {pool_type!r} is not ported")
    if pooling_convention not in ("valid", "full"):
        raise MXNetError(f"Pooling: pooling_convention "
                         f"{pooling_convention!r} not in ('valid', 'full')")

    def fn(x):
        sd = x.dim() - 2
        if kernel:
            _layout_check(layout, len(kernel), "Pooling")
        if global_pool:
            axes = tuple(range(2, x.dim()))
            if pool_type == "max":
                return x.amax(dim=axes, keepdim=True)
            if pool_type == "sum":
                return x.sum(dim=axes, keepdim=True)
            return x.mean(dim=axes, keepdim=True)
        k = tuple(kernel)
        s = tuple(stride) if stride else (1,) * sd
        p = tuple(pad) if pad else (0,) * sd
        widths = []                       # F.pad order: last dim first
        for i in reversed(range(sd)):
            hi = p[i]
            if pooling_convention == "full":
                size = x.shape[2 + i] + 2 * p[i]
                out = -(-(size - k[i]) // s[i]) + 1
                hi += max(0, (out - 1) * s[i] + k[i] - size)
            widths += [p[i], hi]
        if pool_type == "max":
            xp = F.pad(x, widths, value=float("-inf")) if any(widths) else x
            return _MAX_POOL[sd](xp, k, s)
        xp = F.pad(x, widths) if any(widths) else x
        avg = _AVG_POOL[sd](xp, k, s)
        window = 1
        for ki in k:
            window *= ki
        if pool_type == "sum":
            return avg * window
        if count_include_pad or not any(widths):
            return avg
        ones = F.pad(torch.ones_like(x[:1, :1]), widths)
        return avg * window / (_AVG_POOL[sd](ones, k, s) * window)
    return fn


_ACTIVATIONS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softrelu": F.softplus,
    "softsign": lambda x: x / (1 + torch.abs(x)),
}


def activation_maker(act_type="relu"):
    if act_type not in _ACTIVATIONS:
        raise MXNetError(f"Activation: act_type {act_type!r} not in "
                         f"{tuple(_ACTIVATIONS)}")
    return _ACTIVATIONS[act_type]


def softmax_maker(axis=-1, temperature=None, length=None, dtype=None,
                  use_length=False):
    out_dt = None if dtype is None else torch_dtype(dtype)

    def fn(x, length_arr=None):
        xs = x / temperature if temperature else x
        if use_length:
            if length_arr is None:
                raise MXNetError("softmax: use_length=True needs a length "
                                 "input")
            ax = axis % x.dim()
            pos = torch.arange(x.shape[ax], device=x.device)
            pos = pos.reshape([-1 if d == ax else 1 for d in range(x.dim())])
            lens = length_arr.long()
            mask = pos < lens.reshape(lens.shape +
                                      (1,) * (x.dim() - lens.dim()))
            out = torch.softmax(xs.masked_fill(~mask, float("-inf")), ax)
            res = out.masked_fill(~mask, 0.0)
        else:
            res = torch.softmax(xs, dim=axis)
        return res if out_dt is None else res.to(out_dt)
    return fn


def log_softmax_maker(axis=-1, temperature: Optional[float] = None,
                      dtype=None, use_length=False):
    """``log(softmax(data / temperature))`` over ``axis``
    (``temperature`` None or 0 means 1).  ``dtype``, if given, is the
    output dtype; ``use_length`` is not ported.  Under AMP the input is
    cast to float32 (an ``FP32_OPS`` op)."""
    if use_length:
        raise MXNetError("log_softmax: use_length=True is not ported")
    out_dt = None if dtype is None else torch_dtype(dtype)

    def fn(data):
        data, = _amp.cast("log_softmax", data)
        xs = data / temperature if temperature else data
        res = torch.log_softmax(xs, dim=axis)
        return res if out_dt is None else res.to(out_dt)
    return fn


class _SoftmaxOutput(torch.autograd.Function):
    """Softmax over axis 1; the backward of ``data`` is (p - onehot) *
    scale whatever the head gradient (MXNet's fused output layer)."""

    @staticmethod
    def forward(ctx, x, label, grad_scale, ignore_label, use_ignore,
                normalization):
        p = torch.softmax(x, dim=1)
        ctx.save_for_backward(p, label)
        ctx.conf = (grad_scale, ignore_label, use_ignore, normalization)
        return p

    @staticmethod
    def backward(ctx, _head):
        p, label = ctx.saved_tensors
        grad_scale, ignore_label, use_ignore, normalization = ctx.conf
        lab = label.long()
        pm = p.movedim(1, -1)                       # class axis last
        classes = torch.arange(p.shape[1], device=p.device)
        grad = pm - (lab.unsqueeze(-1) == classes).to(p.dtype)
        keep = None
        if use_ignore:
            keep = lab != int(ignore_label)
            grad = grad * keep.unsqueeze(-1).to(grad.dtype)
        scale = float(grad_scale)
        if normalization == "batch":
            scale /= p.shape[0]
        elif normalization == "valid" and keep is not None:
            grad = grad / keep.sum().clamp(min=1).to(grad.dtype)
        return (grad * scale).movedim(-1, 1), None, None, None, None, None


def softmax_output_maker(grad_scale=1.0, ignore_label=-1, multi_output=False,
                         use_ignore=False, preserve_shape=False,
                         normalization="null", out_grad=False,
                         smooth_alpha=0.0):
    if normalization not in ("null", "batch", "valid"):
        raise MXNetError(f"SoftmaxOutput: normalization {normalization!r} "
                         f"not in ('null', 'batch', 'valid')")
    if smooth_alpha:
        raise MXNetError("SoftmaxOutput: smooth_alpha is not ported")

    def fn(x, label):
        return _SoftmaxOutput.apply(x, label, grad_scale, ignore_label,
                                    use_ignore, normalization)
    return fn


def batchnorm_maker(eps=1e-3, momentum=0.9, fix_gamma=True,
                    use_global_stats=False, output_mean_var=False, axis=1,
                    cudnn_off=None):
    def fn(x, gamma, beta, moving_mean, moving_var):
        ax = axis % x.dim()
        dims = tuple(i for i in range(x.dim()) if i != ax)
        shape = [1] * x.dim()
        shape[ax] = x.shape[ax]
        g = torch.ones_like(gamma) if fix_gamma else gamma
        if autograd.is_training() and not use_global_stats:
            var, mean = torch.var_mean(x.float(), dim=dims, unbiased=False)
            with torch.no_grad():
                moving_mean.mul_(momentum).add_(
                    (1 - momentum) * mean.to(moving_mean.dtype))
                moving_var.mul_(momentum).add_(
                    (1 - momentum) * var.to(moving_var.dtype))
        else:
            mean, var = moving_mean, moving_var
        inv = torch.rsqrt(var.to(x.dtype) + eps)
        out = (x - mean.to(x.dtype).reshape(shape)) * \
            (inv * g.to(x.dtype)).reshape(shape) + \
            beta.to(x.dtype).reshape(shape)
        return (out, mean, var) if output_mean_var else out
    return fn


def dropout_maker(p=0.5, mode="training", axes=(), cudnn_off=None):
    def fn(x):
        if p <= 0.0 or (mode != "always" and not autograd.is_training()):
            return x.clone()
        keep = 1.0 - p
        shape = list(x.shape)
        for a in axes:
            shape[a] = 1
        mask = torch.empty(shape, device=x.device, dtype=x.dtype)
        mask.bernoulli_(keep, generator=_random.generator(x.device))
        return x * mask / keep
    return fn


def _register():
    register_op("FullyConnected", fully_connected_maker,
                aliases=("fully_connected",))
    register_op("Convolution", convolution_maker, aliases=("convolution",))
    register_op("Pooling", pooling_maker, aliases=("pooling",))
    register_op("Activation", activation_maker, aliases=("activation",))
    register_op("softmax", softmax_maker)
    register_op("log_softmax", log_softmax_maker)
    register_op("SoftmaxOutput", softmax_output_maker,
                aliases=("softmax_output",))
    register_op("BatchNorm", batchnorm_maker, aliases=("batch_norm",))
    register_op("Dropout", dropout_maker, aliases=("dropout",))


_register()
