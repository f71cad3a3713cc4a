"""BaseModule: the Module API's training driver (``fit``, ``score``,
``predict``).

Counterpart of ``mxnet_tpu/module/base_module.py``: the epoch loop
(forward, backward, update, metric, batch and epoch callbacks,
validation) every Symbol-era script drives, over the subclass surface
(``bind``, ``init_params``, ``init_optimizer``, ``forward``,
``backward``, ``update``, ``get_outputs``, ``update_metric``).
``fit(monitor=)`` installs an ``mx.monitor.Monitor`` on the module's
executors (``install_monitor``) and wraps each batch's forward, backward
and update in its ``tic`` and ``toc_print``.
"""
from __future__ import annotations

import logging
import time
from typing import List

from .. import metric as metric_mod
from ..base import MXNetError
from ..model import BatchEndParam
from ..ndarray import NDArray

__all__ = ["BaseModule"]


def _as_metric(m):
    if isinstance(m, metric_mod.EvalMetric):
        return m
    return metric_mod.create(m)


class BaseModule:
    """Shared high-level API; subclasses implement the *_impl surface
    (bind / init_params / forward / backward / update / get_outputs)."""

    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self.for_training = False
        self.inputs_need_grad = False

    # ------------------------------------------------------------------ #
    # subclass surface                                                   #
    # ------------------------------------------------------------------ #
    @property
    def data_names(self) -> List[str]:
        raise NotImplementedError

    @property
    def output_names(self) -> List[str]:
        raise NotImplementedError

    @property
    def data_shapes(self):
        raise NotImplementedError

    @property
    def label_shapes(self):
        raise NotImplementedError

    @property
    def output_shapes(self):
        raise NotImplementedError

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        raise NotImplementedError

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False,
                    allow_extra=False):
        raise NotImplementedError

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=None, force_init=False):
        raise NotImplementedError

    def forward(self, data_batch, is_train=None):
        raise NotImplementedError

    def backward(self, out_grads=None):
        raise NotImplementedError

    def update(self):
        raise NotImplementedError

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError

    def get_params(self):
        raise NotImplementedError

    def update_metric(self, eval_metric, labels):
        raise NotImplementedError

    def install_monitor(self, mon) -> None:
        """Install ``mon`` on the module's executors."""
        mon.install()

    # ------------------------------------------------------------------ #
    # generic conveniences (reference: base_module.py)                   #
    # ------------------------------------------------------------------ #
    def forward_backward(self, data_batch) -> None:
        self.forward(data_batch, is_train=True)
        self.backward()

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False) -> None:
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init, allow_extra=allow_extra)

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, reset=True, epoch=0) -> list:
        """Evaluate on a DataIter; returns name/value pairs."""
        if not self.binded or not self.params_initialized:
            raise MXNetError("score() requires bind + init_params")
        eval_metric = _as_metric(eval_metric)
        if reset:
            eval_data.reset()
        eval_metric.reset()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            if batch_end_callback is not None:
                param = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                      eval_metric=eval_metric, locals=None)
                for cb in _as_list(batch_end_callback):
                    cb(param)
        return eval_metric.get_name_value()

    def iter_predict(self, eval_data, num_batch=None, reset=True):
        """Yield ``(outputs, nbatch, batch)`` for each batch of
        ``eval_data`` run forward in predict mode."""
        if reset:
            eval_data.reset()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            yield self.get_outputs(), nbatch, eval_batch

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False):
        """Forward over an iterator and collect outputs."""
        if not self.binded or not self.params_initialized:
            raise MXNetError("predict() requires bind + init_params")
        if reset:
            eval_data.reset()
        output_list: List[List[NDArray]] = []
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            outs = self.get_outputs()
            if eval_batch.pad:
                outs = [o[0:o.shape[0] - eval_batch.pad] for o in outs]
            output_list.append(outs)
        if not output_list:
            return output_list
        if merge_batches:
            num_outputs = len(output_list[0])
            from ..ndarray import concat as nd_concat
            merged = [nd_concat(*[o[i] for o in output_list], dim=0)
                      for i in range(num_outputs)]
            if num_outputs == 1 and not always_output_list:
                return merged[0]
            return merged
        return output_list

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", optimizer="sgd",
            optimizer_params=None, eval_end_callback=None,
            eval_batch_end_callback=None, initializer=None,
            arg_params=None, aux_params=None, allow_missing=False,
            force_rebind=False, force_init=False, begin_epoch=0,
            num_epoch=None, validation_metric=None, monitor=None) -> None:
        """MXNet's symbolic training loop: bind, init_params,
        init_optimizer, then per epoch per batch ``forward_backward``,
        ``update``, ``update_metric`` and the batch callbacks; the epoch
        callbacks, a ``score`` on ``eval_data``, ``train_data.reset()``."""
        if num_epoch is None:
            raise MXNetError("fit() requires num_epoch")
        optimizer_params = optimizer_params or {"learning_rate": 0.01}
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params,
                            force_init=force_init)
        eval_metric = _as_metric(eval_metric)
        validation_metric = _as_metric(validation_metric) \
            if validation_metric is not None else eval_metric
        if monitor is not None:
            self.install_monitor(monitor)

        for epoch in range(begin_epoch, num_epoch):
            tic = time.time()
            eval_metric.reset()
            for nbatch, data_batch in enumerate(train_data):
                if monitor is not None:
                    monitor.tic()
                self.forward_backward(data_batch)
                self.update()
                if monitor is not None:
                    monitor.toc_print()
                self.update_metric(eval_metric, data_batch.label)
                if batch_end_callback is not None:
                    param = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                          eval_metric=eval_metric,
                                          locals=None)
                    for cb in _as_list(batch_end_callback):
                        cb(param)
            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name,
                                 val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                             time.time() - tic)
            if epoch_end_callback is not None:
                arg, aux = self.get_params()
                for cb in _as_list(epoch_end_callback):
                    cb(epoch, self.symbol, arg, aux)
            if eval_data is not None:
                res = self.score(
                    eval_data, validation_metric,
                    batch_end_callback=eval_batch_end_callback,
                    epoch=epoch)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f",
                                     epoch, name, val)
            train_data.reset()


def _as_list(x):
    return x if isinstance(x, (list, tuple)) else [x]
