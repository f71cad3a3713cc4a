"""Evaluation metrics: ``EvalMetric``, ``Accuracy``, ``TopKAccuracy``,
``F1``, ``MAE``, ``MSE``, ``RMSE``, ``CrossEntropy``,
``NegativeLogLikelihood``, ``PearsonCorrelation``, ``MCC``,
``Perplexity``, ``Loss``, ``CompositeEvalMetric``, ``CustomMetric``,
``np``, ``register`` and ``create``.

Counterpart of ``mxnet_tpu/metric.py`` (all of it), with its
conventions (``F1``'s ``macro`` is the mean of each update's F1; MAE,
MSE and RMSE average over updates; ``PearsonCorrelation`` and ``MCC``
cover everything updated since ``reset``): ``Perplexity`` is ``exp`` of
the mean ``-log p(label)`` over the rows of ``pred.reshape(-1,
classes)`` (probabilities floored at 1e-12), rows whose label is
``ignore_label`` left out (the keyword is ``ignore_label``; other
keywords, such as the examples' ``invalid_label``, are kept and change
nothing, as in the JAX package); ``CrossEntropy`` is the mean ``-log(p
+ eps)``; ``Loss`` the mean of the outputs themselves; ``create`` takes
a name, an instance, a function or a list (a ``CompositeEvalMetric``).
``update(labels, preds)`` takes
``NDArray``s or tensors on any device (or numpy arrays) and reads them
on the host, as MXNet's metrics do; ``get()`` returns ``(name,
value)``.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as _np
import torch

from .base import MXNetError
from .ndarray.ndarray import NDArray

__all__ = ["EvalMetric", "Accuracy", "TopKAccuracy", "F1", "MAE", "MSE",
           "RMSE", "CrossEntropy", "Perplexity", "Loss",
           "NegativeLogLikelihood", "PearsonCorrelation", "MCC",
           "CompositeEvalMetric", "CustomMetric", "register", "create", "np"]

_registry: Dict[str, type] = {}
_ALIASES = {"acc": "accuracy", "ce": "crossentropy",
            "top_k_accuracy": "topkaccuracy", "top_k_acc": "topkaccuracy"}


def register(klass):
    _registry[klass.__name__.lower()] = klass
    return klass


def create(metric, *args, **kwargs) -> "EvalMetric":
    """A metric by registered name or alias (``"accuracy"``, ``"acc"``,
    ``"top_k_acc"``), an instance as is, a function ``feval(label,
    pred)`` as a ``CustomMetric``, or a list of any of them as a
    ``CompositeEvalMetric``."""
    if isinstance(metric, EvalMetric):
        return metric
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
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


def _to_np(x) -> _np.ndarray:
    if isinstance(x, NDArray):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return _np.asarray(x)


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
            pred = pred.astype(_np.int32).flatten()
            label = label.astype(_np.int32).flatten()
            if pred.shape != label.shape:
                raise MXNetError(f"shape mismatch {pred.shape} vs "
                                 f"{label.shape}")
            self.sum_metric += float((pred == label).sum())
            self.num_inst += len(pred)


@register
class TopKAccuracy(EvalMetric):
    """Share of labels among the ``top_k`` largest predictions."""

    def __init__(self, top_k=1, name="top_k_accuracy", **kwargs):
        super().__init__(f"{name}_{top_k}", **kwargs)
        self.top_k = top_k

    def update(self, labels, preds) -> None:
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label = _to_np(label).astype(_np.int32)
            pred = _to_np(pred)
            topk = _np.argsort(-pred, axis=-1)[..., :self.top_k]
            hit = (topk == label.reshape(label.shape + (1,))).any(axis=-1)
            self.sum_metric += float(hit.sum())
            self.num_inst += hit.size


@register
class F1(EvalMetric):
    """Binary F1: ``macro`` the mean of each update's F1, ``micro`` the F1
    of the pooled counts."""

    def __init__(self, name="f1", average="macro", **kwargs):
        super().__init__(name, **kwargs)
        self.average = average
        self.reset()

    def reset(self):
        super().reset()
        self._tp = self._fp = self._fn = 0.0

    @staticmethod
    def _f1(tp, fp, fn):
        prec = tp / max(tp + fp, 1e-12)
        rec = tp / max(tp + fn, 1e-12)
        return 2 * prec * rec / max(prec + rec, 1e-12)

    def update(self, labels, preds) -> None:
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label = _to_np(label).astype(_np.int32).flatten()
            pred = _to_np(pred)
            if pred.ndim > 1:
                pred = pred.argmax(axis=-1)
            pred = pred.astype(_np.int32).flatten()
            tp = float(((pred == 1) & (label == 1)).sum())
            fp = float(((pred == 1) & (label == 0)).sum())
            fn = float(((pred == 0) & (label == 1)).sum())
            if self.average == "macro":
                self.sum_metric += self._f1(tp, fp, fn)
            else:
                self._tp += tp
                self._fp += fp
                self._fn += fn
            self.num_inst += 1

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        if self.average == "macro":
            return (self.name, self.sum_metric / self.num_inst)
        return (self.name, self._f1(self._tp, self._fp, self._fn))


class _PerUpdate(EvalMetric):
    """A metric that is the mean over updates of ``_value(label,
    pred)``."""

    def update(self, labels, preds) -> None:
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            self.sum_metric += float(self._value(_to_np(label),
                                                 _to_np(pred)))
            self.num_inst += 1


@register
class MAE(_PerUpdate):
    def __init__(self, name="mae", **kwargs):
        super().__init__(name, **kwargs)

    @staticmethod
    def _value(label, pred):
        return _np.abs(label - pred).mean()


@register
class MSE(_PerUpdate):
    def __init__(self, name="mse", **kwargs):
        super().__init__(name, **kwargs)

    @staticmethod
    def _value(label, pred):
        return ((label - pred) ** 2).mean()


@register
class RMSE(_PerUpdate):
    def __init__(self, name="rmse", **kwargs):
        super().__init__(name, **kwargs)

    @staticmethod
    def _value(label, pred):
        return _np.sqrt(((label - pred) ** 2).mean())


@register
class CrossEntropy(EvalMetric):
    """Mean ``-log(p[label] + eps)`` over the rows of ``pred``."""

    def __init__(self, eps=1e-12, name="cross-entropy", **kwargs):
        super().__init__(name, **kwargs)
        self.eps = eps

    def update(self, labels, preds) -> None:
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label = _to_np(label).astype(_np.int32).flatten()
            pred = _to_np(pred)
            prob = pred[_np.arange(label.shape[0]), label]
            self.sum_metric += float((-_np.log(prob + self.eps)).sum())
            self.num_inst += label.shape[0]


@register
class NegativeLogLikelihood(EvalMetric):
    """Mean ``-log(p[label] + eps)`` over the rows of ``pred`` reshaped
    to (labels, classes)."""

    def __init__(self, eps=1e-12, name="nll-loss", **kwargs):
        super().__init__(name, **kwargs)
        self.eps = eps

    def update(self, labels, preds) -> None:
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label = _to_np(label).astype(_np.int32).flatten()
            pred = _to_np(pred).reshape(label.shape[0], -1)
            prob = pred[_np.arange(label.shape[0]), label]
            self.sum_metric += float((-_np.log(prob + self.eps)).sum())
            self.num_inst += label.shape[0]


@register
class PearsonCorrelation(EvalMetric):
    """Pearson's r over everything updated so far (accumulated moments
    in float64)."""

    def __init__(self, name="pearsonr", **kwargs):
        super().__init__(name, **kwargs)
        self.reset()

    def reset(self) -> None:
        super().reset()
        self._n = 0
        self._sx = self._sy = self._sxx = self._syy = self._sxy = 0.0

    def update(self, labels, preds) -> None:
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            x = _to_np(label).astype(_np.float64).ravel()
            y = _to_np(pred).astype(_np.float64).ravel()
            self._n += x.size
            self._sx += x.sum()
            self._sy += y.sum()
            self._sxx += (x * x).sum()
            self._syy += (y * y).sum()
            self._sxy += (x * y).sum()
        n = self._n
        if n == 0:
            return
        self.num_inst = 1
        cov = self._sxy - self._sx * self._sy / n
        vx = self._sxx - self._sx ** 2 / n
        vy = self._syy - self._sy ** 2 / n
        self.sum_metric = float(cov / _np.sqrt(max(vx * vy, 1e-24)))


@register
class MCC(EvalMetric):
    """Binary Matthews correlation coefficient of the counts so far (a
    prediction with several columns is reduced by argmax, one column
    thresholded at 0.5)."""

    def __init__(self, name="mcc", **kwargs):
        super().__init__(name, **kwargs)
        self.reset()

    def reset(self) -> None:
        super().reset()
        self._tp = self._tn = self._fp = self._fn = 0

    def update(self, labels, preds) -> None:
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            y = _to_np(label).astype(_np.int32).ravel()
            p = _to_np(pred)
            yhat = (p.reshape(y.shape[0], -1).argmax(-1)
                    if p.ndim > 1 and p.shape[-1] > 1
                    else (p.ravel() > 0.5).astype(_np.int32))
            self._tp += int(((yhat == 1) & (y == 1)).sum())
            self._tn += int(((yhat == 0) & (y == 0)).sum())
            self._fp += int(((yhat == 1) & (y == 0)).sum())
            self._fn += int(((yhat == 0) & (y == 1)).sum())
        tp, tn, fp, fn = self._tp, self._tn, self._fp, self._fn
        denom = _np.sqrt(float(tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
        self.num_inst = 1
        self.sum_metric = ((tp * tn - fp * fn) / denom) if denom else 0.0


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
            label = _to_np(label).astype(_np.int32).flatten()
            pred = _to_np(pred)
            pred = pred.reshape(-1, pred.shape[-1])
            prob = pred[_np.arange(label.shape[0]), label]
            if self.ignore_label is not None:
                ignore = label == self.ignore_label
                prob = _np.where(ignore, 1.0, prob)
                num = int((~ignore).sum())
            else:
                num = label.shape[0]
            self.sum_metric += float(-_np.log(_np.maximum(prob, 1e-12)).sum())
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


class CustomMetric(EvalMetric):
    """A metric from ``feval(label, pred)`` on numpy arrays, which
    returns a value (one instance) or ``(sum, count)``."""

    def __init__(self, feval, name="custom", allow_extra_outputs=False,
                 **kwargs):
        super().__init__(f"custom({name})", **kwargs)
        self._feval = feval

    def update(self, labels, preds) -> None:
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            v = self._feval(_to_np(label), _to_np(pred))
            if isinstance(v, tuple):
                s, n = v
                self.sum_metric += s
                self.num_inst += n
            else:
                self.sum_metric += v
                self.num_inst += 1


def np(numpy_feval, name="custom", allow_extra_outputs=False):
    """A :class:`CustomMetric` named after ``numpy_feval`` (MXNet's
    ``mx.metric.np``)."""
    def feval(label, pred):
        return numpy_feval(label, pred)
    feval.__name__ = getattr(numpy_feval, "__name__", name)
    return CustomMetric(feval, name=feval.__name__,
                        allow_extra_outputs=allow_extra_outputs)
