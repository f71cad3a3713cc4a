"""Training callbacks: ``Speedometer``, ``do_checkpoint`` and
``module_checkpoint``.

Counterpart of ``mxnet_tpu/callback.py``.  ``Speedometer`` logs samples
per second and the metric every ``frequent`` batches and keeps the last
reading in ``speeds``.  Its window is an ``observability.trace`` span
(``callback.speed_window_us``), as in the JAX package, so the same number
is a histogram on the metrics endpoint and a block on ``mx.profiler``'s
timeline.
"""
from __future__ import annotations

import logging

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
