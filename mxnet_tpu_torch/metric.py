"""Evaluation metrics: ``EvalMetric``, ``Accuracy``, ``CrossEntropy``,
``Perplexity``, ``Loss``, ``CompositeEvalMetric``, ``register`` and
``create``.

Counterpart of ``mxnet_tpu/metric.py`` (:25-113, :216-375), with its
conventions: ``Perplexity`` is ``exp`` of the mean ``-log p(label)`` over
the rows of ``pred.reshape(-1, classes)`` (probabilities floored at
1e-12), rows whose label is ``ignore_label`` left out (the keyword is
``ignore_label``; other keywords, such as the examples'
``invalid_label``, are kept and change nothing, as in the JAX package);
``CrossEntropy`` is the mean ``-log(p + eps)``; ``Loss`` the mean of the
outputs themselves; ``create`` takes a name, an instance or a list
(a ``CompositeEvalMetric``).  ``update(labels, preds)`` takes
``NDArray``s or tensors on any device (or numpy arrays) and reads them
on the host, as MXNet's metrics do; ``get()`` returns ``(name,
value)``.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from .base import MXNetError
from .ndarray.ndarray import NDArray

__all__ = ["EvalMetric", "Accuracy", "CrossEntropy", "Perplexity", "Loss",
           "CompositeEvalMetric", "register", "create"]

_registry: Dict[str, type] = {}
_ALIASES = {"acc": "accuracy", "ce": "crossentropy"}


def register(klass):
    _registry[klass.__name__.lower()] = klass
    return klass


def create(metric, *args, **kwargs) -> "EvalMetric":
    """A metric by registered name (``"accuracy"``, ``"acc"``), an
    instance as is, or a list of either as a ``CompositeEvalMetric``."""
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, (list, tuple)):
        composite = CompositeEvalMetric()
        for m in metric:
            composite.add(create(m, *args, **kwargs))
        return composite
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


@register
class CrossEntropy(EvalMetric):
    """Mean ``-log(p[label] + eps)`` over the rows of ``pred``."""

    def __init__(self, eps=1e-12, name="cross-entropy", **kwargs):
        super().__init__(name, **kwargs)
        self.eps = eps

    def update(self, labels, preds) -> None:
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label = _to_np(label).astype(np.int32).flatten()
            pred = _to_np(pred)
            prob = pred[np.arange(label.shape[0]), label]
            self.sum_metric += float((-np.log(prob + self.eps)).sum())
            self.num_inst += label.shape[0]


@register
class Perplexity(EvalMetric):
    """``exp`` of the mean ``-log p(label)`` (see the module docstring)."""

    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 **kwargs):
        super().__init__(name, **kwargs)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds) -> None:
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label = _to_np(label).astype(np.int32).flatten()
            pred = _to_np(pred)
            pred = pred.reshape(-1, pred.shape[-1])
            prob = pred[np.arange(label.shape[0]), label]
            if self.ignore_label is not None:
                ignore = label == self.ignore_label
                prob = np.where(ignore, 1.0, prob)
                num = int((~ignore).sum())
            else:
                num = label.shape[0]
            self.sum_metric += float(-np.log(np.maximum(prob, 1e-12)).sum())
            self.num_inst += num

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.exp(self.sum_metric / self.num_inst))


@register
class Loss(EvalMetric):
    """Mean of the outputs (a loss the graph computes)."""

    def __init__(self, name="loss", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, _, preds) -> None:
        for pred in _as_list(preds):
            loss = _to_np(pred)
            self.sum_metric += float(loss.sum())
            self.num_inst += loss.size


class CompositeEvalMetric(EvalMetric):
    """Several metrics updated together; ``get`` gives their names and
    values as two lists."""

    def __init__(self, metrics=None, name="composite", **kwargs):
        super().__init__(name, **kwargs)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric) -> None:
        self.metrics.append(create(metric))

    def update(self, labels, preds) -> None:
        for m in self.metrics:
            m.update(labels, preds)

    def reset(self) -> None:
        for m in getattr(self, "metrics", []):
            m.reset()

    def get(self):
        names, values = [], []
        for m in self.metrics:
            n, v = m.get()
            names.append(n)
            values.append(v)
        return (names, values)
