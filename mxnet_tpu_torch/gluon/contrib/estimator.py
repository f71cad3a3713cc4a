"""Gluon's ``Estimator``: ``fit``/``evaluate`` over a data iterator with
event handlers.

Counterpart of ``mxnet_tpu/gluon/contrib/estimator.py`` (MXNet 1.6's
``gluon/contrib/estimator``): ``Estimator.fit`` runs epochs of batches
(a ``DataIter``'s ``DataBatch``es or ``(data, label)`` pairs), each an
``autograd.record()`` forward, the loss's ``backward()`` and
``trainer.step(batch_size)``, and fires the lifecycle events (train,
epoch and batch begin and end) at its handlers: ``StoppingHandler``
(``max_epoch``, ``max_batch``), ``MetricHandler``,
``ValidationHandler``, ``LoggingHandler``, ``CheckpointHandler``
(``save_parameters`` and the trainer's ``save_states``) and
``EarlyStoppingHandler``, with the event base classes ``TrainBegin``,
``TrainEnd``, ``EpochBegin``, ``EpochEnd``, ``BatchBegin`` and
``BatchEnd``.  The step is the port's ordinary one, so a hybridized net
replays its captured graphs and ``gluon.Trainer``'s SGD runs in the
multi-SGD kernels; the handlers run on the host between steps.
"""
from __future__ import annotations

import logging
import time
from typing import List, Optional, Sequence

from ... import autograd as _autograd
from ... import metric as _metric
from ...base import MXNetError
from ..trainer import Trainer as _Trainer
from .. import loss as _gloss

__all__ = ["Estimator", "TrainBegin", "TrainEnd", "EpochBegin",
           "EpochEnd", "BatchBegin", "BatchEnd", "StoppingHandler",
           "MetricHandler", "ValidationHandler", "LoggingHandler",
           "CheckpointHandler", "EarlyStoppingHandler"]


# -- event mixins (reference event_handler.py class names) ------------------

class TrainBegin:
    def train_begin(self, estimator):
        pass


class TrainEnd:
    def train_end(self, estimator):
        pass


class EpochBegin:
    def epoch_begin(self, estimator):
        pass


class EpochEnd:
    def epoch_end(self, estimator):
        pass


class BatchBegin:
    def batch_begin(self, estimator):
        pass


class BatchEnd:
    def batch_end(self, estimator):
        pass


class StoppingHandler(TrainBegin, BatchEnd, EpochEnd):
    """Stop after ``max_epoch`` epochs or ``max_batch`` total batches."""

    def __init__(self, max_epoch=None, max_batch=None):
        self.max_epoch = max_epoch
        self.max_batch = max_batch

    def train_begin(self, estimator):
        if self.max_epoch is not None:
            estimator.max_epoch = self.max_epoch

    def batch_end(self, estimator):
        if self.max_batch is not None and \
                estimator.processed_batches >= self.max_batch:
            estimator.stop_training = True

    def epoch_end(self, estimator):
        if self.max_epoch is not None and \
                estimator.current_epoch + 1 >= self.max_epoch:
            estimator.stop_training = True


class MetricHandler(EpochBegin, BatchEnd):
    """Reset train metrics per epoch; update them per batch."""

    def __init__(self, metrics):
        self.metrics = metrics

    def epoch_begin(self, estimator):
        for m in self.metrics:
            m.reset()

    def batch_end(self, estimator):
        for m in self.metrics:
            if isinstance(m, _metric.Loss):
                # loss metrics consume the batch LOSS, not (label, pred)
                m.update(0, estimator._batch_loss)
            else:
                m.update(estimator._batch_label, estimator._batch_pred)


class ValidationHandler(EpochEnd):
    """Run evaluate() on ``val_data`` every ``epoch_period`` epochs."""

    def __init__(self, val_data, eval_fn, epoch_period=1):
        self.val_data = val_data
        self.eval_fn = eval_fn
        self.epoch_period = epoch_period

    def epoch_end(self, estimator):
        if (estimator.current_epoch + 1) % self.epoch_period == 0:
            self.eval_fn(self.val_data)


class LoggingHandler(TrainBegin, TrainEnd, EpochEnd, BatchEnd):
    """Metric logging: per-epoch by default; ``log_interval=N`` adds a
    line every N batches (the reference's batch mode)."""

    def __init__(self, log_interval="epoch", metrics=None,
                 logger=None):
        if log_interval != "epoch" and (
                not isinstance(log_interval, int) or log_interval <= 0):
            raise MXNetError(
                "log_interval must be 'epoch' or a positive int")
        self.log_interval = log_interval
        self.metrics = metrics
        self.logger = logger or logging.getLogger("mxnet_tpu_torch.estimator")
        self._t0 = None

    def train_begin(self, estimator):
        self._t0 = time.perf_counter()
        self.logger.info("Training begin: %s epochs",
                         estimator.max_epoch)

    def train_end(self, estimator):
        self.logger.info("Training finished in %.1fs",
                         time.perf_counter() - self._t0)

    def _line(self):
        return " ".join(f"{n}={v:.4f}" for n, v in
                        (m.get() for m in self.metrics or []))

    def batch_end(self, estimator):
        if self.log_interval == "epoch":
            return
        if estimator.processed_batches % self.log_interval == 0:
            ms = self.metrics or ([estimator.loss_metric]
                                  + estimator.train_metrics)
            line = " ".join(f"{n}={v:.4f}"
                            for n, v in (m.get() for m in ms))
            self.logger.info("[batch %d] %s",
                             estimator.processed_batches, line)

    def epoch_end(self, estimator):
        parts = []
        for m in (self.metrics or estimator.train_metrics):
            name, val = m.get()
            parts.append(f"{name}={val:.4f}")
        self.logger.info("[epoch %d] %s", estimator.current_epoch,
                         " ".join(parts))


class CheckpointHandler(TrainBegin, EpochEnd):
    """Save parameters (+ trainer states) per epoch; optionally only on
    monitored-metric improvement (``save_best``)."""

    def __init__(self, model_dir, model_prefix="model", monitor=None,
                 mode="min", save_best=False, epoch_period=1):
        import os
        self.model_dir = model_dir
        self.model_prefix = model_prefix
        self.monitor = monitor
        self.save_best = save_best
        self.epoch_period = epoch_period
        if mode not in ("min", "max"):
            raise MXNetError("CheckpointHandler mode must be min|max")
        self.mode = mode
        self.best = None
        os.makedirs(model_dir, exist_ok=True)

    def _better(self, v):
        if self.best is None:
            return True
        return v < self.best if self.mode == "min" else v > self.best

    def epoch_end(self, estimator):
        import os
        if (estimator.current_epoch + 1) % self.epoch_period:
            return
        prefix = os.path.join(self.model_dir, self.model_prefix)
        if self.save_best:
            if self.monitor is None:
                raise MXNetError("save_best requires a monitor metric")
            _, v = self.monitor.get()
            if not self._better(v):
                return
            self.best = v
            estimator.net.save_parameters(f"{prefix}-best.params")
        else:
            estimator.net.save_parameters(
                f"{prefix}-epoch{estimator.current_epoch}.params")
        if estimator.trainer is not None:
            # disk/permission errors must surface; only a trainer without
            # savable state is a legitimate no-op
            if hasattr(estimator.trainer, "save_states"):
                estimator.trainer.save_states(f"{prefix}.states")


class EarlyStoppingHandler(EpochEnd):
    """Stop when the monitored metric fails to improve ``patience``
    consecutive epochs (min_delta slack, reference semantics)."""

    def __init__(self, monitor, mode="min", patience=3, min_delta=0.0):
        if mode not in ("min", "max"):
            raise MXNetError("EarlyStoppingHandler mode must be min|max")
        self.monitor = monitor
        self.mode = mode
        self.patience = patience
        self.min_delta = min_delta
        self.best = None
        self.bad_epochs = 0

    def epoch_end(self, estimator):
        _, v = self.monitor.get()
        improved = self.best is None or (
            v < self.best - self.min_delta if self.mode == "min"
            else v > self.best + self.min_delta)
        if improved:
            self.best = v
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs >= self.patience:
                estimator.stop_training = True


class Estimator:
    """The fit/evaluate loop (reference estimator.py).

    Parameters: ``net`` (Block), ``loss`` (gluon loss Block),
    ``train_metrics`` (EvalMetric or list), ``trainer`` (built from
    net.collect_params if omitted), ``context`` accepted for signature
    parity."""

    def __init__(self, net, loss, train_metrics=None, trainer=None,
                 context=None):
        del context
        self.net = net
        self.loss = loss
        if not isinstance(loss, _gloss.Loss):
            raise MXNetError("Estimator needs a gluon loss Block")
        if train_metrics is None:
            train_metrics = []
        elif isinstance(train_metrics, _metric.EvalMetric):
            train_metrics = [train_metrics]
        self.train_metrics = list(train_metrics) or [_metric.Accuracy()]
        self.loss_metric = _metric.Loss()
        # validation runs on CLONES so an epoch-end validation pass never
        # resets/overwrites the epoch's training statistics
        self.val_metrics = [type(m)() for m in self.train_metrics]
        self.trainer = trainer or _Trainer(
            net.collect_params(), "adam", {"learning_rate": 1e-3})
        self.stop_training = False
        self.current_epoch = 0
        self.processed_batches = 0
        self.max_epoch = None

    # -- evaluation --------------------------------------------------------
    def evaluate(self, val_data, val_metrics=None):
        metrics = val_metrics or self.val_metrics
        for m in metrics:
            m.reset()
        for batch in val_data:
            x, y = self._split(batch)
            pred = self.net(x)
            for m in metrics:
                m.update(y, pred)
        if hasattr(val_data, "reset"):
            val_data.reset()            # DataIter: rewind for next epoch
        return [m.get() for m in metrics]

    # -- training ----------------------------------------------------------
    def fit(self, train_data, val_data=None, epochs=1,
            event_handlers: Optional[Sequence] = None,
            batch_size: Optional[int] = None):
        handlers = self._default_handlers(val_data,
                                          list(event_handlers or []))
        self.max_epoch = epochs
        self.stop_training = False
        self.processed_batches = 0

        def fire(kind):
            for h in handlers:
                getattr(h, kind)(self) if hasattr(h, kind) else None

        fire("train_begin")
        for epoch in range(epochs):
            self.current_epoch = epoch
            fire("epoch_begin")
            for batch in train_data:
                fire("batch_begin")
                x, y = self._split(batch)
                bs = batch_size or (x.shape[0] if hasattr(x, "shape")
                                    else len(x))
                with _autograd.record():
                    pred = self.net(x)
                    loss = self.loss(pred, y)
                loss.backward()
                self.trainer.step(bs)
                self._batch_pred = pred
                self._batch_label = y
                self._batch_loss = loss
                self.processed_batches += 1
                fire("batch_end")
                if self.stop_training:
                    break
            if hasattr(train_data, "reset"):
                train_data.reset()
            fire("epoch_end")
            if self.stop_training:
                break
        fire("train_end")
        return self

    def _default_handlers(self, val_data, handlers: List):
        has = lambda t: any(isinstance(h, t) for h in handlers)  # noqa
        if not has(MetricHandler):
            handlers.insert(0, MetricHandler(
                [self.loss_metric] + self.train_metrics))
        if val_data is not None and not has(ValidationHandler):
            handlers.append(ValidationHandler(val_data, self.evaluate))
        if not has(StoppingHandler):
            handlers.append(StoppingHandler())
        return handlers

    @staticmethod
    def _split(batch):
        if hasattr(batch, "data"):          # DataBatch
            d = batch.data[0] if isinstance(batch.data, (list, tuple)) \
                else batch.data
            lb = batch.label[0] if isinstance(batch.label, (list, tuple)) \
                else batch.label
            return d, lb
        x, y = batch
        from ...ndarray import NDArray, array
        if not isinstance(x, NDArray):
            x = array(x)
        if not isinstance(y, NDArray):
            y = array(y)
        return x, y
