"""Gluon losses: ``L2Loss``, ``L1Loss``, ``SigmoidBinaryCrossEntropyLoss``,
``SoftmaxCrossEntropyLoss``, ``KLDivLoss``, ``HuberLoss``, ``HingeLoss``,
``SquaredHingeLoss``, ``LogisticLoss``, ``TripletLoss``,
``CosineEmbeddingLoss``, ``PoissonNLLLoss``, ``SDMLLoss`` and ``CTCLoss``.

Counterpart of ``mxnet_tpu/gluon/loss.py``, with its reduction semantics:
a loss returns one value per sample, the mean over every axis but
``batch_axis``; ``sample_weight`` multiplies elementwise (broadcast) and
``weight`` is a scalar factor (RCNN's ``(N, 1)`` weight on an ``(N, C)``
softmax loss weighs each sample).  Back-propagate a per-sample loss with
``autograd.backward(loss)`` (a head gradient of ones, as MXNet's
``loss.backward()``), or, on ``NDArray`` inputs (``Block.__call__``
returns an ``NDArray``), with ``loss.backward()`` itself.  The exceptions
are the JAX package's: ``TripletLoss``, ``CosineEmbeddingLoss`` and
``CTCLoss`` weigh their per-sample loss without a mean, ``PoissonNLLLoss``
and ``SDMLLoss`` return the mean over everything (a scalar).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..base import MXNetError
from ..ndarray import log_softmax
from ..ndarray.ops_ctc import ctc_loss_maker
from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "HuberLoss", "HingeLoss", "SquaredHingeLoss",
           "LogisticLoss", "TripletLoss", "CosineEmbeddingLoss", "CTCLoss",
           "PoissonNLLLoss", "SDMLLoss"]


def _apply_weighting(loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        if not isinstance(weight, (int, float)):
            raise MXNetError("weight must be a number")
        loss = loss * weight
    return loss


def _weighting_sym(F, loss, weight=None, sample_weight=None):
    """``_apply_weighting`` in graph ops (the JAX package's
    ``mxnet_tpu/gluon/loss.py:19-26``), for the symbolic bodies."""
    if sample_weight is not None:
        loss = F.broadcast_mul(loss, sample_weight)
    if weight is not None:
        if not isinstance(weight, (int, float)):
            raise MXNetError("weight must be a number")
        loss = loss * weight
    return loss


class Loss(HybridBlock):
    def __init__(self, weight, batch_axis, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._weight = weight
        self._batch_axis = batch_axis

    def _batch_mean(self, loss):
        """Mean over every axis except ``batch_axis``."""
        axes = [a for a in range(loss.ndim)
                if a != self._batch_axis % loss.ndim]
        return loss.mean(dim=axes) if axes else loss


class L2Loss(Loss):
    """``weight / 2 * (label - pred)^2``, label reshaped to pred."""

    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def forward(self, pred, label, sample_weight=None):
        loss = torch.square(label.reshape(pred.shape) - pred)
        return self._batch_mean(
            _apply_weighting(loss, self._weight / 2, sample_weight))


class SoftmaxCrossEntropyLoss(Loss):
    """``-log_softmax(pred)[label]`` (``sparse_label``: integer class ids,
    float labels truncated, out-of-range ids clipped) or ``-sum(label *
    log_softmax(pred))`` over ``axis``; ``from_logits`` takes ``pred`` as
    log-probabilities already."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = log_softmax(pred, axis=self._axis)   # FP32 under AMP
        ax = self._axis % pred.ndim
        if self._sparse_label:
            idx = label.long().clamp(0, pred.shape[ax] - 1)
            loss = -torch.gather(pred, ax, idx.unsqueeze(ax))
        else:
            loss = -(pred * label.reshape(pred.shape)).sum(dim=ax,
                                                           keepdim=True)
        return self._batch_mean(
            _apply_weighting(loss, self._weight, sample_weight))

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        """The symbolic body (``mxnet_tpu/gluon/loss.py:110-119``)."""
        if not self._from_logits:
            pred = F.log_softmax(pred, axis=self._axis)
        if self._sparse_label:
            loss = -F.pick(pred, label, axis=self._axis, keepdims=True)
        else:
            loss = -F.sum(pred * F.reshape_like(label, pred),
                          axis=self._axis, keepdims=True)
        loss = _weighting_sym(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class SigmoidBinaryCrossEntropyLoss(Loss):
    """Binary cross-entropy: on logits (``from_sigmoid=False``) in the
    stable form ``relu(x) - x * y + softplus(-|x|)``, or on probabilities
    as ``-(log(p + 1e-12) * y + log(1 - p + 1e-12) * (1 - y))``;
    ``pos_weight`` scales the positive term (JAX ``loss.py:69-101``)."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def forward(self, pred, label, sample_weight=None, pos_weight=None):
        label = label.reshape(pred.shape)
        if not self._from_sigmoid:
            soft = F.softplus(-pred.abs())
            loss = torch.relu(pred) - pred * label + soft
            if pos_weight is not None:
                loss = loss + (pos_weight - 1) * label * (
                    torch.relu(-pred) + soft)
        else:
            eps = 1e-12
            pos = torch.log(pred + eps) * label
            if pos_weight is not None:
                pos = pos * pos_weight
            loss = -(pos + torch.log(1 - pred + eps) * (1 - label))
        return self._batch_mean(
            _apply_weighting(loss, self._weight, sample_weight))


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class L1Loss(Loss):
    """``|label - pred|``, label reshaped to pred."""

    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def forward(self, pred, label, sample_weight=None):
        loss = (label.reshape(pred.shape) - pred).abs()
        return self._batch_mean(
            _apply_weighting(loss, self._weight, sample_weight))


class KLDivLoss(Loss):
    """``label * (log(label + 1e-12) - pred)``, ``pred`` log-probabilities
    (``from_logits``) or logits, log-softmaxed over ``axis``."""

    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._axis = axis

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = torch.log_softmax(pred, dim=self._axis)
        loss = label * (torch.log(label + 1e-12) - pred)
        return self._batch_mean(
            _apply_weighting(loss, self._weight, sample_weight))

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        """The symbolic body (``mxnet_tpu/gluon/loss.py:132-137``)."""
        if not self._from_logits:
            pred = F.log_softmax(pred, axis=self._axis)
        loss = label * (F.log(label + 1e-12) - pred)
        loss = _weighting_sym(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class HuberLoss(Loss):
    """``|d| - rho / 2`` where ``|d| > rho``, else ``d^2 / (2 rho)``."""

    def __init__(self, rho=1.0, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def forward(self, pred, label, sample_weight=None):
        d = (label.reshape(pred.shape) - pred).abs()
        loss = torch.where(d > self._rho, d - 0.5 * self._rho,
                           (0.5 / self._rho) * torch.square(d))
        return self._batch_mean(
            _apply_weighting(loss, self._weight, sample_weight))


class HingeLoss(Loss):
    """``relu(margin - pred * label)``, labels -1 or 1."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        loss = torch.relu(self._margin - pred * label.reshape(pred.shape))
        return self._batch_mean(
            _apply_weighting(loss, self._weight, sample_weight))


class SquaredHingeLoss(Loss):
    """``relu(margin - pred * label)^2``."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        loss = torch.square(torch.relu(
            self._margin - pred * label.reshape(pred.shape)))
        return self._batch_mean(
            _apply_weighting(loss, self._weight, sample_weight))


class LogisticLoss(Loss):
    """Binary logistic loss on logits, labels -1/1 (``signed``) or 0/1
    (``binary``)."""

    def __init__(self, weight=None, batch_axis=0, label_format="signed",
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        if label_format not in ("signed", "binary"):
            raise MXNetError(f"bad label_format {label_format}")
        self._label_format = label_format

    def forward(self, pred, label, sample_weight=None):
        label = label.reshape(pred.shape)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        loss = torch.relu(pred) - pred * label + F.softplus(-pred.abs())
        return self._batch_mean(
            _apply_weighting(loss, self._weight, sample_weight))


class TripletLoss(Loss):
    """``relu(sum(|positive - pred|^2 - |negative - pred|^2) + margin)``
    over every axis but ``batch_axis``."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, pred, positive, negative, sample_weight=None):
        d = torch.square(positive.reshape(pred.shape) - pred) - \
            torch.square(negative.reshape(pred.shape) - pred)
        axes = [a for a in range(d.ndim) if a != self._batch_axis % d.ndim]
        loss = torch.relu((d.sum(dim=axes) if axes else d) + self._margin)
        return _apply_weighting(loss, self._weight, sample_weight)


class CosineEmbeddingLoss(Loss):
    """``1 - cos(input1, input2)`` where ``label`` is 1, else ``relu(cos -
    margin)``; inputs flattened past the batch axis."""

    def __init__(self, weight=None, batch_axis=0, margin=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, input1, input2, label, sample_weight=None):
        if input1.ndim > 2:
            input1 = input1.reshape(input1.shape[0], -1)
        if input2.ndim > 2:
            input2 = input2.reshape(input2.shape[0], -1)
        dot = (input1 * input2).sum(dim=-1)
        n1 = torch.sqrt(torch.square(input1).sum(dim=-1) + 1e-12)
        n2 = torch.sqrt(torch.square(input2).sum(dim=-1) + 1e-12)
        cos = dot / (n1 * n2)
        loss = torch.where(label.reshape(-1) == 1, 1 - cos,
                           torch.relu(cos - self._margin))
        return _apply_weighting(loss, self._weight, sample_weight)


class PoissonNLLLoss(Loss):
    """Poisson negative log likelihood of ``target`` under the mean
    ``pred`` (its log, ``from_logits``), with Stirling's term for targets
    above 1 (``compute_full``, mean form only); the mean over
    everything."""

    def __init__(self, weight=None, from_logits=True, batch_axis=0,
                 compute_full=False, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._compute_full = compute_full

    def forward(self, pred, target, sample_weight=None, epsilon=1e-08):
        target = target.reshape(pred.shape)
        if self._from_logits:
            loss = torch.exp(pred) - target * pred
        else:
            loss = pred - target * torch.log(pred + epsilon)
            if self._compute_full:
                stirling = target * torch.log(target + epsilon) - target \
                    + 0.5 * torch.log(2 * math.pi * (target + epsilon))
                loss = loss + torch.where(target > 1.0, stirling,
                                          torch.zeros_like(target))
        return _apply_weighting(loss, self._weight, sample_weight).mean()


class SDMLLoss(Loss):
    """Smoothed deep metric learning: row i of ``x1`` and of ``x2`` are the
    only positive pair; the cross-entropy of a smoothed one-hot target
    against the softmax of the negated squared distances, averaged."""

    def __init__(self, smoothing_parameter=0.3, weight=1.0, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._smoothing = smoothing_parameter

    def forward(self, x1, x2, sample_weight=None):
        n = x1.shape[0]
        d = torch.square(x1.unsqueeze(1) - x2.unsqueeze(0)).sum(dim=-1)
        logp = torch.log_softmax(-d, dim=-1)
        eye = torch.eye(n, dtype=logp.dtype, device=logp.device)
        smooth = eye * (1.0 - self._smoothing) + \
            (1.0 - eye) * (self._smoothing / max(n - 1, 1))
        loss = -(smooth * logp).sum(dim=-1)
        return _apply_weighting(loss, self._weight, sample_weight).mean()


class CTCLoss(Loss):
    """Connectionist Temporal Classification (the ``CTCLoss`` op,
    ``blank_label="last"``: class ``C - 1`` is the blank, labels padded
    with -1).  ``pred`` is (N, T, C) for ``layout`` "NTC" or (T, N, C)
    for "TNC"; ``label`` (N, L) for "NT" or (L, N) for "TN"."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None,
                 **kwargs):
        if layout not in ("NTC", "TNC"):
            raise MXNetError(f"unsupported CTCLoss layout {layout}")
        if label_layout not in ("NT", "TN"):
            raise MXNetError(f"unsupported label layout {label_layout}")
        super().__init__(weight, label_layout.find("N"), **kwargs)
        self._layout = layout
        self._label_layout = label_layout

    def forward(self, pred, label, pred_lengths=None, label_lengths=None,
                sample_weight=None):
        if self._layout == "NTC":
            pred = pred.transpose(0, 1)
        if self._label_layout == "TN":
            label = label.transpose(0, 1)
        fn = ctc_loss_maker(pred_lengths is not None,
                            label_lengths is not None, "last")
        lengths = [v for v in (pred_lengths, label_lengths) if v is not None]
        return _apply_weighting(fn(pred, label, *lengths), self._weight,
                                sample_weight)

    def hybrid_forward(self, F, pred, label, pred_lengths=None,
                       label_lengths=None, sample_weight=None):
        """The symbolic body (``mxnet_tpu/gluon/loss.py:312-327``)."""
        if self._layout == "NTC":
            pred = F.swapaxes(pred, dim1=0, dim2=1)
        if self._label_layout == "TN":
            label = F.swapaxes(label, dim1=0, dim2=1)
        lengths = [v for v in (pred_lengths, label_lengths) if v is not None]
        loss = F.CTCLoss(pred, label, *lengths,
                         use_data_lengths=pred_lengths is not None,
                         use_label_lengths=label_lengths is not None,
                         blank_label="last")
        return _weighting_sym(F, loss, self._weight, sample_weight)
