"""Neural-network operators: ``FullyConnected``, ``Convolution``,
``Deconvolution``, ``Pooling``, ``Activation``, ``LeakyReLU``,
``softmax``/``log_softmax``/``softmin``, ``SoftmaxOutput``, ``BatchNorm``,
``LayerNorm``, ``GroupNorm``, ``LRN``, ``InstanceNorm``,
``L2Normalization``, ``Dropout``, ``UpSampling``, ``BilinearResize2D``,
the legacy ``_v1`` names and the fused ``RNN``.

Counterpart of ``mxnet_tpu/ndarray/ops_nn.py``: FullyConnected :24-33
(``flatten``, ``no_bias``), Convolution :60-84 (NCW/NCHW/NCDHW data, OI..
weights), Pooling :118-187 (max/avg/sum, ``global_pool``,
``pooling_convention`` valid/full, ``count_include_pad``), Activation
:191-200, softmax :226-242, log_softmax :244-250, softmin :252-257, SoftmaxOutput :262-303,
BatchNorm :306-331, Dropout :437-448, and the rest of the file: Deconvolution
:115, LeakyReLU :223, LayerNorm :359, GroupNorm :383, LRN :405,
InstanceNorm :417, L2Normalization :434, UpSampling and BilinearResize2D
:452-496, the ``_v1`` ops (:87, :188, :333; ``BatchNorm_v1`` keeps
BatchNorm's defaults on axis 1) and RNN :497-583.  The JAX package leaves
all of them to XLA, outside any Pallas kernel; here they are torch
calls, ``RNN`` through torch's recurrent calls (``torch.lstm``,
``torch.gru``, ``torch.rnn_tanh``, ``torch.rnn_relu``: cuDNN on the card,
torch's own loop on the CPU), whose per-layer weights ``(w_ih, w_hh,
b_ih, b_hh)`` and gate orders (LSTM i, f, g, o; GRU r, z, n with
``r * (W_hn h + b_hn)``) are the JAX op's.  MXNet's conventions hold:

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

import math
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
        if pooling_convention == "valid" and pool_type != "sum" and all(
                pi <= ki // 2 for pi, ki in zip(p, k)):
            # torch pads implicitly (-inf for max, zeros for average)
            if pool_type == "max":
                return _MAX_POOL[sd](x, k, s, p)
            return _AVG_POOL[sd](x, k, s, p,
                                 count_include_pad=count_include_pad)
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


def softmin_maker(axis=-1, temperature: Optional[float] = None, dtype=None):
    """``softmax(-data / temperature)`` over ``axis``; ``dtype``, if given,
    is the output dtype (MXNet's; the JAX op ignores it).  Under AMP the
    input is cast to float32 (an ``FP32_OPS`` op)."""
    out_dt = None if dtype is None else torch_dtype(dtype)

    def fn(data):
        data, = _amp.cast("softmin", data)
        xs = data / temperature if temperature else data
        res = torch.softmax(-xs, dim=axis)
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


_DECONV = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def deconvolution_maker(kernel=(), stride=None, dilate=None, pad=None,
                        adj=None, target_shape=None, num_filter=None,
                        num_group=1, no_bias=True, layout=None,
                        workspace=None, cudnn_tune=None, cudnn_off=None):
    """MXNet's transposed convolution, weight ``(in, num_filter // group,
    *kernel)``: output ``(in - 1) * stride - 2 * pad + dilate * (k - 1) +
    1 + adj``, or ``target_shape`` (which sets ``adj``).  The JAX op
    (:115) ignores ``dilate`` and ``target_shape``; the port honours both,
    as MXNet does."""
    nd = len(kernel)
    _layout_check(layout, nd, "Deconvolution")
    stride_ = tuple(stride) if stride else (1,) * nd
    dilate_ = tuple(dilate) if dilate else (1,) * nd
    pad_ = tuple(pad) if pad else (0,) * nd

    def fn(x, w, b=None):
        adj_ = tuple(adj) if adj else (0,) * nd
        if target_shape:
            adj_ = tuple(
                int(t) - ((x.shape[2 + i] - 1) * stride_[i] - 2 * pad_[i]
                          + dilate_[i] * (kernel[i] - 1) + 1)
                for i, t in enumerate(target_shape))
        return _DECONV[nd](x, w, None if no_bias else b, stride_, pad_,
                           adj_, num_group, dilate_)
    return fn


_SELU = (1.6732632423543772, 1.0507009873554805)


def leaky_relu_maker(act_type="leaky", slope=0.25, lower_bound=0.125,
                     upper_bound=0.334):
    """``leaky`` (``slope``), ``prelu`` (the learned ``gamma``, one per
    channel of axis 1, or one), ``elu`` (``slope`` as alpha), ``selu``,
    ``gelu`` (the erf form) and ``rrelu``.  ``rrelu`` follows MXNet: in
    training mode each negative unit draws its slope from U(lower_bound,
    upper_bound) (the port's generator), otherwise the mean slope; the
    JAX op (:223) always takes the mean slope."""
    if act_type not in ("leaky", "prelu", "elu", "selu", "gelu", "rrelu"):
        raise MXNetError(f"LeakyReLU: act_type {act_type!r} is not one of "
                         f"leaky, prelu, elu, selu, gelu, rrelu")

    def fn(x, gamma=None):
        if act_type == "leaky":
            return torch.where(x >= 0, x, slope * x)
        if act_type == "prelu":
            if gamma is None:
                raise MXNetError("LeakyReLU(act_type='prelu') needs gamma")
            g = gamma.reshape((1, -1) + (1,) * (x.dim() - 2)) \
                if x.dim() > 1 else gamma
            return torch.where(x >= 0, x, g * x)
        if act_type == "elu":
            return torch.where(x >= 0, x, slope * torch.expm1(x))
        if act_type == "selu":
            alpha, scale = _SELU
            return scale * torch.where(x >= 0, x, alpha * torch.expm1(x))
        if act_type == "gelu":
            return F.gelu(x)
        if autograd.is_training():
            s = torch.empty_like(x).uniform_(
                lower_bound, upper_bound,
                generator=_random.generator(x.device))
        else:
            s = (lower_bound + upper_bound) / 2.0
        return torch.where(x >= 0, x, s * x)
    return fn


def layernorm_maker(axis=-1, eps=1e-5, output_mean_var=False):
    """Normalise over ``axis``; with ``output_mean_var`` also the mean and
    the (biased) variance, that axis dropped."""
    def fn(x, gamma, beta):
        ax = axis % x.dim()
        shape = [1] * x.dim()
        shape[ax] = x.shape[ax]
        var, mean = torch.var_mean(x, dim=ax, keepdim=True,
                                   correction=0)
        out = (x - mean) * torch.rsqrt(var + eps) * gamma.reshape(shape) \
            + beta.reshape(shape)
        if output_mean_var:
            return out, mean.squeeze(ax), var.squeeze(ax)
        return out
    return fn


def groupnorm_maker(num_groups=1, eps=1e-5, output_mean_var=False):
    """Statistics over each (sample, group of channels); ``gamma`` and
    ``beta`` are per group, ``(num_groups,)``, the JAX package's
    convention (:383)."""
    g = int(num_groups)

    def fn(x, gamma, beta):
        n, c, rest = x.shape[0], x.shape[1], tuple(x.shape[2:])
        xg = x.reshape((n, g, c // g) + rest)
        dims = tuple(range(2, xg.dim()))
        var, mean = torch.var_mean(xg, dim=dims, keepdim=True,
                                   correction=0)
        bshape = (1, g, 1) + (1,) * len(rest)
        out = ((xg - mean) * torch.rsqrt(var + eps) * gamma.reshape(bshape)
               + beta.reshape(bshape)).reshape(x.shape)
        if output_mean_var:
            return out, mean.reshape(n, g), var.reshape(n, g)
        return out
    return fn


def lrn_maker(alpha=1e-4, beta=0.75, knorm=2.0, nsize=5):
    """Cross-channel local response normalisation: ``x / (knorm + alpha /
    nsize * sum of x^2 over the nsize channels around)^beta``."""
    def fn(x):
        return F.local_response_norm(x, int(nsize), alpha, beta, knorm)
    return fn


def instancenorm_maker(eps=1e-3):
    def fn(x, gamma, beta):
        dims = tuple(range(2, x.dim()))
        var, mean = torch.var_mean(x, dim=dims, keepdim=True, correction=0)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return (x - mean) * torch.rsqrt(var + eps) * gamma.reshape(shape) \
            + beta.reshape(shape)
    return fn


def l2normalization_maker(eps=1e-10, mode="instance"):
    if mode not in ("instance", "channel", "spatial"):
        raise MXNetError(f"L2Normalization: mode {mode!r} is not one of "
                         f"instance, channel, spatial")

    def fn(x):
        dims = {"instance": tuple(range(1, x.dim())), "channel": (1,),
                "spatial": tuple(range(2, x.dim()))}[mode]
        return x / torch.sqrt(torch.square(x).sum(dim=dims, keepdim=True)
                              + eps)
    return fn


def upsampling_maker(scale=1, num_filter=0, sample_type="nearest",
                     multi_input_mode="concat", num_args=1, workspace=None):
    """``nearest``: each pixel repeated ``scale`` times on H and W (several
    inputs are each brought to the first's size times ``scale``, then
    concatenated on the channels or summed, ``multi_input_mode``);
    ``bilinear``: a linear resize by ``scale`` with half-pixel centres,
    the JAX op's (:452; MXNet's takes a deconvolution weight instead)."""
    if sample_type not in ("nearest", "bilinear"):
        raise MXNetError(f"UpSampling: sample_type {sample_type!r}")

    def fn(*xs):
        x = xs[0]
        size = (x.shape[2] * scale, x.shape[3] * scale)
        if sample_type == "bilinear":
            return F.interpolate(x, size=size, mode="bilinear",
                                 align_corners=False)
        ups = [t.repeat_interleave(size[0] // t.shape[2], 2)
               .repeat_interleave(size[1] // t.shape[3], 3) for t in xs]
        if len(ups) == 1:
            return ups[0]
        if multi_input_mode == "sum":
            return torch.stack(ups).sum(0)
        return torch.cat(ups, dim=1)
    return fn


def bilinear_resize_maker(height=None, width=None, scale_height=None,
                          scale_width=None, mode="size",
                          align_corners=True):
    """Bilinear resize of (N, C, H, W) to ``height`` x ``width`` (or the
    scales); ``align_corners`` maps the corners onto each other, MXNet's
    kernel (src = dst * (in - 1) / (out - 1))."""
    def fn(x):
        h, w = x.shape[2], x.shape[3]
        nh = height if height else int(h * scale_height)
        nw = width if width else int(w * scale_width)
        return F.interpolate(x, size=(int(nh), int(nw)), mode="bilinear",
                             align_corners=bool(align_corners),
                             antialias=not align_corners and
                             (nh < h or nw < w))
    return fn


def batchnorm_v1_maker(eps=1e-3, momentum=0.9, fix_gamma=True,
                       use_global_stats=False, output_mean_var=False):
    """The pre-0.12 op (``src/operator/batch_norm_v1.cc``): BatchNorm on
    channel axis 1, no other options."""
    return batchnorm_maker(eps=eps, momentum=momentum, fix_gamma=fix_gamma,
                           use_global_stats=use_global_stats,
                           output_mean_var=output_mean_var, axis=1)


# ---- RNN: the fused multi-layer recurrent op (:497-583) ------------------

RNN_GATES = {"lstm": 4, "gru": 3, "rnn_tanh": 1, "rnn_relu": 1}
_RNN_CALLS = {"lstm": torch.lstm, "gru": torch.gru,
              "rnn_tanh": torch.rnn_tanh, "rnn_relu": torch.rnn_relu}
#: the cuDNN mode of each (``torch.nn.modules.rnn``'s numbering)
CUDNN_MODE = {"rnn_relu": 0, "rnn_tanh": 1, "lstm": 2, "gru": 3}


def rnn_param_size(mode, num_layers, input_size, hidden_size,
                   bidirectional=False) -> int:
    """Elements of the flat parameter vector of ``RNN``: per layer and
    direction ``w_ih, w_hh, b_ih, b_hh``."""
    ng, nd = RNN_GATES[mode], 2 if bidirectional else 1
    total, lin = 0, input_size
    for _ in range(num_layers):
        total += nd * (ng * hidden_size * (lin + hidden_size)
                       + 2 * ng * hidden_size)
        lin = hidden_size * nd
    return total


def rnn_layer_params(flat: torch.Tensor, mode: str, num_layers: int,
                     input_size: int, hidden_size: int,
                     bidirectional: bool):
    """Views of ``flat`` as each layer's ``[w_ih, w_hh, b_ih, b_hh]`` per
    direction, in the JAX op's slicing order (``ops_nn.py:554-558``)."""
    ng, nd, h = RNN_GATES[mode], 2 if bidirectional else 1, hidden_size
    off, lin, layers = 0, input_size, []
    for _ in range(num_layers):
        mine = []
        for _ in range(nd):
            for shape in ((ng * h, lin), (ng * h, h), (ng * h,), (ng * h,)):
                n = math.prod(shape)
                mine.append(flat[off:off + n].view(shape))
                off += n
        layers.append(mine)
        lin = h * nd
    return layers


def rnn_run(mode: str, x, layers, h0, c0, bidirectional: bool, p: float):
    """Run ``layers`` (each ``[w_ih, w_hh, b_ih, b_hh]`` per direction) over
    ``x`` (T, N, C), one torch recurrent call a layer (cuDNN on the card,
    torch's own loop on the CPU), with dropout ``p`` on every layer's
    output but the last in training mode, drawn from the port's
    generator as ``Dropout`` draws.  Returns the output and the final
    ``h`` (and ``c`` for an LSTM), each (layers * directions, N, H)."""
    call, nd = _RNN_CALLS[mode], 2 if bidirectional else 1
    drop = dropout_maker(p) if p > 0 else None
    # cuDNN keeps what its backward needs only in its training form
    train = torch.is_grad_enabled()
    hs, cs = [], []
    for i, params in enumerate(layers):
        h = h0[i * nd:(i + 1) * nd]
        if mode == "lstm":
            x, hn, cn = call(x, (h, c0[i * nd:(i + 1) * nd]), params, True,
                             1, 0.0, train, bidirectional, False)
            cs.append(cn)
        else:
            x, hn = call(x, h, params, True, 1, 0.0, train, bidirectional,
                         False)
        hs.append(hn)
        if drop is not None and i + 1 < len(layers):
            x = drop(x)
    hn = torch.cat(hs) if len(hs) > 1 else hs[0]
    if mode == "lstm":
        return x, hn, torch.cat(cs) if len(cs) > 1 else cs[0]
    return x, hn


def rnn_maker(state_size=0, num_layers=1, mode="lstm", bidirectional=False,
              p=0.0, state_outputs=False, projection_size=None,
              use_sequence_length=False, lstm_state_clip_min=None,
              lstm_state_clip_max=None, lstm_state_clip_nan=False):
    """``RNN(data (T, N, C), parameters, state[, state_cell])``: the flat
    ``parameters`` (``rnn_param_size``) are sliced into views, no copy.
    Outputs: the sequence, then with ``state_outputs`` the final states
    (MXNet's count; the JAX op returns them always).  ``p`` is applied
    between layers in training mode, as MXNet's cuDNN op does (the JAX op
    ignores it).  ``projection_size``, ``use_sequence_length`` and the
    LSTM state clips, which the JAX op ignores, raise."""
    if mode not in RNN_GATES:
        raise MXNetError(f"RNN: mode {mode!r} not in {tuple(RNN_GATES)}")
    for name, v in (("projection_size", projection_size),
                    ("use_sequence_length", use_sequence_length),
                    ("lstm_state_clip_min", lstm_state_clip_min),
                    ("lstm_state_clip_max", lstm_state_clip_max),
                    ("lstm_state_clip_nan", lstm_state_clip_nan)):
        if v:
            raise MXNetError(f"RNN: {name} is not ported")

    def fn(data, params, state, state_cell=None):
        if params.numel() != rnn_param_size(mode, num_layers, data.shape[2],
                                            state_size, bidirectional):
            raise MXNetError(f"RNN: {params.numel()} parameters for "
                             f"{num_layers} {mode} layers of {state_size} "
                             f"over {data.shape[2]} inputs")
        layers = rnn_layer_params(params, mode, num_layers, data.shape[2],
                                  state_size, bidirectional)
        if mode == "lstm" and state_cell is None:
            raise MXNetError("RNN: an LSTM needs state_cell")
        outs = rnn_run(mode, data, layers, state, state_cell, bidirectional,
                       p if autograd.is_training() else 0.0)
        return outs if state_outputs else outs[0]
    return fn


def _register():
    register_op("FullyConnected", fully_connected_maker,
                aliases=("fully_connected",))
    register_op("Convolution", convolution_maker, aliases=("convolution",))
    # the legacy 0.x names (convolution_v1.cc, pooling_v1.cc): same math
    register_op("Convolution_v1", convolution_maker)
    register_op("Deconvolution", deconvolution_maker,
                aliases=("deconvolution",))
    register_op("Pooling", pooling_maker, aliases=("pooling",))
    register_op("Pooling_v1", pooling_maker)
    register_op("Activation", activation_maker, aliases=("activation",))
    register_op("LeakyReLU", leaky_relu_maker, aliases=("leaky_relu",))
    register_op("softmax", softmax_maker)
    register_op("log_softmax", log_softmax_maker)
    register_op("softmin", softmin_maker)
    register_op("SoftmaxOutput", softmax_output_maker,
                aliases=("softmax_output",))
    register_op("BatchNorm", batchnorm_maker, aliases=("batch_norm",))
    register_op("BatchNorm_v1", batchnorm_v1_maker)
    register_op("LayerNorm", layernorm_maker, aliases=("layer_norm",))
    register_op("GroupNorm", groupnorm_maker, aliases=("group_norm",))
    register_op("LRN", lrn_maker, aliases=("lrn",))
    register_op("InstanceNorm", instancenorm_maker,
                aliases=("instance_norm",))
    register_op("L2Normalization", l2normalization_maker,
                aliases=("l2_normalization",))
    register_op("Dropout", dropout_maker, aliases=("dropout",))
    register_op("UpSampling", upsampling_maker, aliases=("upsampling",))
    register_op("BilinearResize2D", bilinear_resize_maker,
                aliases=("_contrib_BilinearResize2D",))
    register_op("RNN", rnn_maker, aliases=("rnn",))


_register()
