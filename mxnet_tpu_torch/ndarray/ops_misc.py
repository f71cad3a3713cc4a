"""Loss heads, finiteness probes and GluonNLP's fused attention products.

Counterpart of ``mxnet_tpu/ndarray/ops_misc.py``, for the ops of that
file the port has so far: ``all_finite``/``multi_all_finite`` (:66-84),
``softmax_cross_entropy`` (:87-94), the output layers
``LinearRegressionOutput``, ``MAERegressionOutput``,
``LogisticRegressionOutput`` and ``SVMOutput`` (:96-141), the four
``_contrib_interleaved_matmul_*`` ops (:464-548), ``SoftmaxActivation``
(:611-619) and ``MakeLoss`` (:666-688).  The JAX package computes them
in XLA outside any Pallas kernel; here they are torch code.

- ``all_finite``/``multi_all_finite`` answer a 1-element float32 tensor
  on the data's device (1 when every element is finite): nothing is read
  back until the caller reads it.
- The output layers and ``MakeLoss`` are ``torch.autograd.Function``s
  whose backward ignores the head gradient, as MXNet's fused loss layers
  do and as the JAX package's custom VJPs do: the regression outputs
  hand ``data`` ``(y - t) * grad_scale`` (``sign(y - t)`` for MAE; ``y``
  is the sigmoid for the logistic one), ``SVMOutput`` the L2-SVM
  gradient (L1 with ``use_linear``) on the ±1 one-vs-rest encoding of
  the integer label, ``MakeLoss`` ``grad_scale``, divided by the batch
  for ``normalization="batch"`` and by the count of elements above
  ``valid_thresh`` (at least 1) for ``"valid"``.  The label takes no
  gradient.  A regression label with as many elements as ``data`` is
  read in ``data``'s shape, as MXNet reads it.
- The interleaved products take GluonNLP's layouts: projections
  ``(L, B, H * 3 * D)`` (or ``(L, B, H * 2 * D)`` for the encoder's
  keys and values) with q, k and v interleaved per head, attention
  matrices ``(B * H, Lq, Lk)``; ``qk`` scales q by ``1 / sqrt(D)``
  before the product, as the JAX op does, so a bf16 product rounds the
  same way.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from .register import register_op


def all_finite_maker(init_output=True):
    def fn(data):
        return torch.isfinite(data.float()).all().float().reshape(1)
    return fn


def multi_all_finite_maker(num_arrays=1, init_output=True):
    def fn(*arrays):
        ok = torch.stack([torch.isfinite(a.float()).all() for a in arrays])
        return ok.all().float().reshape(1)
    return fn


def softmax_cross_entropy_maker():
    def fn(data, label):
        logp = torch.log_softmax(data, dim=1)
        picked = torch.take_along_dim(logp, label.long()[:, None], dim=1)
        return -picked.sum().reshape(1)
    return fn


class _OutputLayer(torch.autograd.Function):
    """``forward(x)`` as the layer's output; the backward of ``x`` is
    ``grad(y, label) * grad_scale`` whatever the head gradient, and the
    label takes none."""

    @staticmethod
    def forward(ctx, x, label, forward, grad, grad_scale):
        y = forward(x)
        ctx.save_for_backward(y, label)
        ctx.grad, ctx.grad_scale = grad, grad_scale
        return y

    @staticmethod
    def backward(ctx, _head):
        y, label = ctx.saved_tensors
        g = ctx.grad(y, label) * ctx.grad_scale
        return g.to(y.dtype), None, None, None, None


def _as_data(t: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return t.reshape(y.shape) if t.numel() == y.numel() else t


def _identity(x):
    return x.clone()


def _output_layer(forward, grad, grad_scale):
    def fn(data, label):
        return _OutputLayer.apply(data, label, forward, grad,
                                  float(grad_scale))
    return fn


def linear_regression_maker(grad_scale=1.0):
    return _output_layer(_identity, lambda y, t: y - _as_data(t, y),
                         grad_scale)


def mae_regression_maker(grad_scale=1.0):
    return _output_layer(_identity,
                         lambda y, t: torch.sign(y - _as_data(t, y)),
                         grad_scale)


def logistic_regression_maker(grad_scale=1.0):
    return _output_layer(torch.sigmoid, lambda y, t: y - _as_data(t, y),
                         grad_scale)


def svm_output_maker(margin=1.0, regularization_coefficient=1.0,
                     use_linear=False):
    """L2-SVM by default, L1 (hinge) with ``use_linear``
    (``svm_output-inl.h``), on ``t`` the ±1 one-vs-rest label."""
    def grad(y, label):
        classes = torch.arange(y.shape[1], device=y.device)
        t = 2.0 * (label.long()[:, None] == classes).to(y.dtype) - 1.0
        viol = margin - t * y
        active = (viol > 0).to(y.dtype)
        if use_linear:
            return -regularization_coefficient * t * active
        return -2.0 * regularization_coefficient * t * viol * active
    return _output_layer(_identity, grad, 1.0)


class _MakeLoss(torch.autograd.Function):
    """The identity forward; the backward is ``grad_scale`` (normalised)
    whatever the head gradient."""

    @staticmethod
    def forward(ctx, x, grad_scale, valid_thresh, normalization):
        scale = torch.full((), grad_scale, dtype=x.dtype, device=x.device)
        if normalization == "batch":
            scale = scale / x.shape[0]
        elif normalization == "valid":
            valid = (x > valid_thresh).to(x.dtype).sum()
            scale = scale / torch.clamp(valid, min=1.0)
        ctx.save_for_backward(scale)
        ctx.shape = x.shape
        return x.clone()

    @staticmethod
    def backward(ctx, _head):
        scale, = ctx.saved_tensors
        return scale.expand(ctx.shape).clone(), None, None, None


def make_loss_maker(grad_scale=1.0, valid_thresh=0.0, normalization="null"):
    if normalization not in ("null", "batch", "valid"):
        raise MXNetError(f"MakeLoss: normalization {normalization!r} not "
                         f"in ('null', 'batch', 'valid')")

    def fn(x):
        return _MakeLoss.apply(x, float(grad_scale), float(valid_thresh),
                               normalization)
    return fn


def softmax_activation_maker(mode="instance"):
    def fn(x):
        if mode == "channel":
            return torch.softmax(x, dim=1)
        return torch.softmax(x.reshape(x.shape[0], -1),
                             dim=-1).reshape(x.shape)
    return fn


def _heads_of(x: torch.Tensor, heads: int, parts: int):
    """``(L, B, H * parts * D)`` as ``parts`` tensors ``(B * H, L, D)``."""
    L, B, E = x.shape
    d = E // (parts * heads)
    y = x.reshape(L, B, heads, parts, d)
    return [y[:, :, :, i].permute(1, 2, 0, 3).reshape(B * heads, L, d)
            for i in range(parts)]


def _merge_heads(out: torch.Tensor, heads: int, lq: int, b: int):
    d = out.shape[-1]
    return out.reshape(b, heads, lq, d).permute(2, 0, 1, 3) \
        .reshape(lq, b, heads * d)


def selfatt_qk_maker(heads=1):
    def fn(qkv):
        q, k, _ = _heads_of(qkv, heads, 3)
        scale = 1.0 / float(q.shape[-1]) ** 0.5
        return torch.bmm(q * scale, k.transpose(1, 2))
    return fn


def selfatt_valatt_maker(heads=1):
    def fn(qkv, att):
        _, _, v = _heads_of(qkv, heads, 3)
        return _merge_heads(torch.bmm(att, v), heads, qkv.shape[0],
                            qkv.shape[1])
    return fn


def encdec_qk_maker(heads=1):
    def fn(q_proj, kv):
        q, = _heads_of(q_proj, heads, 1)
        k, _ = _heads_of(kv, heads, 2)
        scale = 1.0 / float(q.shape[-1]) ** 0.5
        return torch.bmm(q * scale, k.transpose(1, 2))
    return fn


def encdec_valatt_maker(heads=1):
    def fn(kv, att):
        _, v = _heads_of(kv, heads, 2)
        return _merge_heads(torch.bmm(att, v), heads, att.shape[1],
                            kv.shape[1])
    return fn


def _register():
    register_op("all_finite", all_finite_maker)
    register_op("multi_all_finite", multi_all_finite_maker)
    register_op("softmax_cross_entropy", softmax_cross_entropy_maker)
    register_op("LinearRegressionOutput", linear_regression_maker,
                aliases=("linear_regression_output",))
    register_op("MAERegressionOutput", mae_regression_maker,
                aliases=("mae_regression_output",))
    register_op("LogisticRegressionOutput", logistic_regression_maker,
                aliases=("logistic_regression_output",))
    register_op("SVMOutput", svm_output_maker, aliases=("svm_output",))
    register_op("MakeLoss", make_loss_maker, aliases=("make_loss",))
    register_op("SoftmaxActivation", softmax_activation_maker,
                aliases=("softmax_activation",))
    register_op("_contrib_interleaved_matmul_selfatt_qk", selfatt_qk_maker,
                aliases=("interleaved_matmul_selfatt_qk",))
    register_op("_contrib_interleaved_matmul_selfatt_valatt",
                selfatt_valatt_maker,
                aliases=("interleaved_matmul_selfatt_valatt",))
    register_op("_contrib_interleaved_matmul_encdec_qk", encdec_qk_maker,
                aliases=("interleaved_matmul_encdec_qk",))
    register_op("_contrib_interleaved_matmul_encdec_valatt",
                encdec_valatt_maker,
                aliases=("interleaved_matmul_encdec_valatt",))


_register()
