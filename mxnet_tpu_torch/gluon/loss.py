"""Gluon losses: ``SoftmaxCrossEntropyLoss``, ``SigmoidBinaryCrossEntropyLoss``
and ``L2Loss``.

Counterpart of ``mxnet_tpu/gluon/loss.py``, with its reduction semantics:
a loss returns one value per sample, the mean over every axis but
``batch_axis``; ``sample_weight`` multiplies elementwise (broadcast) and
``weight`` is a scalar factor (RCNN's ``(N, 1)`` weight on an ``(N, C)``
softmax loss weighs each sample).  Back-propagate a per-sample loss with
``autograd.backward(loss)`` (a head gradient of ones, as MXNet's
``loss.backward()``), or, on ``NDArray`` inputs (``Block.__call__``
returns an ``NDArray``), with ``loss.backward()`` itself.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError
from ..ndarray import log_softmax
from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss"]


def _apply_weighting(loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = loss * sample_weight
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
