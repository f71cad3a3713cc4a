"""Training callbacks: ``Speedometer``, ``do_checkpoint``,
``module_checkpoint``, ``log_train_metric`` and ``ProgressBar``.

Counterpart of ``mxnet_tpu/callback.py``.  ``Speedometer`` logs samples
per second and the metric every ``frequent`` batches and keeps the last
reading in ``speeds``.  Its window is an ``observability.trace`` span
(``callback.speed_window_us``), as in the JAX package, so the same number
is a histogram on the metrics endpoint and a block on ``mx.profiler``'s
timeline.
"""
from __future__ import annotations

import logging

__all__ = ["Speedometer", "do_checkpoint", "module_checkpoint",
           "log_train_metric", "ProgressBar"]


class Speedometer:
    """Log throughput (samples/s) and the metric every ``frequent``
    batches."""

    def __init__(self, batch_size: int, frequent: int = 50,
                 auto_reset: bool = True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.auto_reset = auto_reset
        self.init = False
        self.last_count = 0
        self.speeds = []
        self._window = None           # open span over the current window

    def _restart_window(self) -> None:
        from .observability.trace import span
        self._window = span("callback.speed_window_us",
                            args={"frequent": self.frequent})
        self._window.__enter__()

    def __call__(self, param) -> None:
        count = param.nbatch
        if self.last_count > count:
            self.init = False
        self.last_count = count
        if not self.init:
            self.init = True
            self._restart_window()
            return
        if count % self.frequent:
            return
        win, self._window = self._window, None
        if win is None:
            return
        win.__exit__(None, None, None)
        speed = self.frequent * self.batch_size / (win.duration_us / 1e6)
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
        self._restart_window()


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


def log_train_metric(period: int, auto_reset: bool = False):
    """A batch-end callback logging the metric every ``period`` batches
    (``auto_reset``: reset it after each log)."""

    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            name_value = param.eval_metric.get_name_value()
            for name, value in name_value:
                logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                             param.epoch, param.nbatch, name, value)
            if auto_reset:
                param.eval_metric.reset()
    return _callback


class ProgressBar:
    """A batch-end callback logging a text bar of ``nbatch`` out of
    ``total``."""

    def __init__(self, total: int, length: int = 80):
        self.bar_len = length
        self.total = total

    def __call__(self, param) -> None:
        count = param.nbatch
        filled_len = int(round(self.bar_len * count / float(self.total)))
        percents = int(round(100.0 * count / float(self.total)))
        prog_bar = "=" * filled_len + "-" * (self.bar_len - filled_len)
        logging.info("[%s] %s%s\r", prog_bar, percents, "%")
