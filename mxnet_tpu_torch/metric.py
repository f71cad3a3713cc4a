"""Evaluation metrics: ``EvalMetric``, ``Accuracy``, ``register`` and
``create``.

Counterpart of ``mxnet_tpu/metric.py`` (:25-113).  ``update(labels,
preds)`` takes ``NDArray``s or tensors on any device (or numpy arrays) and reads them on
the host, as MXNet's metrics do; ``get()`` returns ``(name, value)``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .base import MXNetError
from .ndarray.ndarray import NDArray

__all__ = ["EvalMetric", "Accuracy", "register", "create"]

_registry: Dict[str, type] = {}
_ALIASES = {"acc": "accuracy"}


def register(klass):
    _registry[klass.__name__.lower()] = klass
    return klass


def create(metric, *args, **kwargs) -> "EvalMetric":
    """A metric by registered name (``"accuracy"``, ``"acc"``), or an
    instance as is."""
    if isinstance(metric, EvalMetric):
        return metric
    name = str(metric).lower()
    name = _ALIASES.get(name, name)
    if name not in _registry:
        raise MXNetError(f"unknown metric {metric!r}")
    return _registry[name](*args, **kwargs)


def _to_np(x) -> np.ndarray:
    if isinstance(x, NDArray):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


class EvalMetric:
    """Base metric: ``sum_metric`` over ``num_inst`` instances."""

    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def reset(self) -> None:
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds) -> None:
        raise NotImplementedError

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_name_value(self):
        name, value = self.get()
        return list(zip(_as_list(name), _as_list(value)))

    def __str__(self):
        return f"EvalMetric: {dict(self.get_name_value())}"


@register
class Accuracy(EvalMetric):
    """Share of predictions equal to the label; a prediction with more
    dimensions than its label is reduced by argmax over ``axis``."""

    def __init__(self, axis=1, name="accuracy", **kwargs):
        super().__init__(name, **kwargs)
        self.axis = axis

    def update(self, labels, preds) -> None:
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label, pred = _to_np(label), _to_np(pred)
            if pred.ndim > label.ndim:
                pred = pred.argmax(axis=self.axis)
            pred = pred.astype(np.int32).flatten()
            label = label.astype(np.int32).flatten()
            if pred.shape != label.shape:
                raise MXNetError(f"shape mismatch {pred.shape} vs "
                                 f"{label.shape}")
            self.sum_metric += float((pred == label).sum())
            self.num_inst += len(pred)
