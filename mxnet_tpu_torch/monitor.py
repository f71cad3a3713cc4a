"""``mx.monitor.Monitor``: statistics of op outputs and of weights during
training.

Counterpart of ``mxnet_tpu/monitor.py`` (:28-112).  The JAX package's
``Monitor`` taps the engine's dispatch (``engine.add_listener``): every
imperative op of the registry whose name matches ``pattern`` has its
outputs' statistic queued while the monitor is active (between ``tic``
and ``toc``), as a 0-d tensor on the op's device; ``toc`` reads them to
the host once.  The port's engine has the same seam (``Engine.on_op``,
free while no listener is installed).

``install_to_executor(exe)`` follows MXNet 1.x rather than the JAX
package (whose version only installs the tap, so a ``Module``'s graph,
run as one jitted function, shows it nothing): at ``toc`` the arguments
of each such executor whose names match ``pattern`` (``.*weight``) get
their statistic too, after the batch's update, as in MXNet's
``Monitor.toc``.  ``BaseModule.fit(monitor=)`` installs the monitor on
the module's executors and calls ``tic`` before each batch and
``toc_print`` after its update.
"""
from __future__ import annotations

import logging
import re
from typing import Callable, List, Optional, Tuple

import torch

from .engine import engine

__all__ = ["Monitor"]


def _default_stat(x: torch.Tensor) -> torch.Tensor:
    """``||x|| / sqrt(x.size)`` as float32, a 0-d tensor where ``x`` is;
    the squares are summed in float64 (torch's fp32 norms of one
    32000 x 1024 weight on an H100 and on the CPU are 1.5e-3 apart, so
    a statistic in fp32 would depend on where it was taken)."""
    norm = torch.linalg.vector_norm(x, dtype=torch.float64)
    return (norm / float(x.numel()) ** 0.5).to(torch.float32)


class Monitor:
    """Every ``interval`` batches, the statistic ``stat_func`` (a tensor
    -> a 0-d tensor; default ``||x|| / sqrt(size)``) of the outputs of
    the ops, and of the executors' arguments, whose names match
    ``pattern``; ``sort`` orders ``toc``'s rows by name."""

    def __init__(self, interval: int = 1,
                 stat_func: Optional[Callable] = None,
                 pattern: str = ".*", sort: bool = False):
        self.interval = max(1, int(interval))
        self.stat_func = stat_func or _default_stat
        self.re = re.compile(pattern)
        self.sort = sort
        self.activated = False
        self.step = 0
        self.queue: List[Tuple[int, str, object]] = []
        self.exes: list = []
        self._installed = False

    def _tensor(self, x):
        return x._data if hasattr(x, "_data") else x

    def _listener(self, op_name: str, outputs, dispatch_us: float) -> None:
        if not self.activated or not self.re.match(op_name):
            return
        outs = outputs if isinstance(outputs, (list, tuple)) else [outputs]
        for i, o in enumerate(outs):
            name = op_name if len(outs) == 1 else f"{op_name}_output{i}"
            o = self._tensor(o)
            if isinstance(o, torch.Tensor) and not o.is_meta:
                with torch.no_grad():
                    self.queue.append((self.step, name, self.stat_func(o)))

    def install(self) -> None:
        if not self._installed:
            engine().add_listener(self._listener)
            self._installed = True

    def uninstall(self) -> None:
        if self._installed:
            engine().remove_listener(self._listener)
            self._installed = False

    def install_to_executor(self, executor=None) -> None:
        """Install the tap and, given an executor, watch its arguments."""
        self.install()
        if executor is not None and all(e is not executor
                                        for e in self.exes):
            self.exes.append(executor)

    def tic(self) -> None:
        """Start collecting, if this batch is one of every ``interval``."""
        if self.step % self.interval == 0:
            self.activated = True
            self.queue = []

    def toc(self) -> List[Tuple[int, str, str]]:
        """Stop collecting; ``(step, name, statistic as text)`` rows, the
        statistics read to the host here."""
        if not self.activated:
            self.step += 1
            return []
        self.activated = False
        with torch.no_grad():
            for exe in self.exes:
                for name, arr in zip(exe._symbol.list_arguments(),
                                     exe.arg_arrays):
                    if self.re.match(name):
                        self.queue.append((self.step, name, self.stat_func(
                            self._tensor(arr))))
        res = []
        for step, name, val in self.queue:
            v = val.detach().cpu() if isinstance(val, torch.Tensor) \
                else torch.as_tensor(val)
            res.append((step, name, str(float(v)) if v.numel() == 1
                        else str(v.numpy())))
        if self.sort:
            res.sort(key=lambda t: t[1])
        self.queue = []
        self.step += 1
        return res

    def toc_print(self) -> None:
        for step, name, stat in self.toc():
            logging.getLogger().info("Batch: %7d %30s %s", step, name, stat)
