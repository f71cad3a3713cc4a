"""Training callbacks: ``Speedometer``, ``do_checkpoint`` and
``module_checkpoint``.

Counterpart of ``mxnet_tpu/callback.py``.  ``Speedometer`` logs samples
per second and the metric every ``frequent`` batches, over the host's
clock (the JAX package times the window through its tracing spans, which
are not ported), and keeps the last reading in ``speeds``.
"""
from __future__ import annotations

import logging
import time

__all__ = ["Speedometer", "do_checkpoint", "module_checkpoint"]


class Speedometer:
    """Log throughput (samples/s) and the metric every ``frequent``
    batches."""

    def __init__(self, batch_size: int, frequent: int = 50,
                 auto_reset: bool = True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.auto_reset = auto_reset
        self.init = False
        self.tic = 0.0
        self.last_count = 0
        self.speeds = []

    def __call__(self, param) -> None:
        count = param.nbatch
        if self.last_count > count:
            self.init = False
        self.last_count = count
        if not self.init:
            self.init = True
            self.tic = time.perf_counter()
            return
        if count % self.frequent:
            return
        speed = self.frequent * self.batch_size / \
            (time.perf_counter() - self.tic)
        self.speeds.append(speed)
        msg, args = "Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec", \
            [param.epoch, count, speed]
        if param.eval_metric is not None:
            for name, value in param.eval_metric.get_name_value():
                msg += "\t%s=%f"
                args += [name, value]
            if self.auto_reset:
                param.eval_metric.reset()
        logging.info(msg, *args)
        self.tic = time.perf_counter()


def do_checkpoint(prefix: str, period: int = 1):
    """Epoch-end callback writing ``prefix-symbol.json`` and
    ``prefix-%04d.params`` every ``period`` epochs."""
    period = int(max(1, period))

    def _callback(iter_no, sym, arg, aux):
        if (iter_no + 1) % period == 0:
            from .model import save_checkpoint
            save_checkpoint(prefix, iter_no + 1, sym, arg, aux)
    return _callback


def module_checkpoint(mod, prefix: str, period: int = 1,
                      save_optimizer_states: bool = False):
    """Epoch-end callback calling ``mod.save_checkpoint`` every
    ``period`` epochs."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            mod.save_checkpoint(prefix, iter_no + 1, save_optimizer_states)
    return _callback
