"""The execution engine's user surface: engine type and the sync points.

Counterpart of ``mxnet_tpu/engine.py`` (``Engine`` :91, ``wait_all``
:336).  PyTorch's CUDA streams are the port's engine: every op is queued
on the current stream of its device and runs in order there, so what is
left to carry is MXNet's interface:

- the engine type, from ``MXNET_ENGINE_TYPE`` at import or
  ``engine().set_engine_type(name)``.  ``"NaiveEngine"`` synchronises the
  device after every op that the ``nd`` registry runs (MXNet's debug
  engine, every op finished before the next is issued);
- the sync points: ``wait_all()`` (``mx.nd.waitall()``) waits for every
  CUDA device, ``wait_for(tensor)`` (``NDArray.wait_to_read()``) for the
  current stream of the tensor's device;
- the counts of waits and of host reads (``NDArray.asnumpy``/
  ``asscalar``, and the optimizer frontends' reads of a learning-rate
  array on the card), in ``stats()``;
- the dispatch listeners (``add_listener``; ``mx.monitor.Monitor`` and
  ``mx.profiler`` are two), called with each registry op's name, its
  outputs and its host dispatch time in µs (the time to queue the op's
  kernels, not their device time, as the JAX package's is the time to
  dispatch to XLA).  ``hooked`` is false while there is no listener and
  the engine is not naive, and the registry's dispatch then makes no
  call here at all (and reads no clock).

The JAX package's bulked dispatch (``_BulkSegment``, the deferral of op
runs into one fused XLA program) has no counterpart: each op is one or
more kernel launches on the stream as it is called.
"""
from __future__ import annotations

import torch

from .base import get_env, register_env

__all__ = ["Engine", "engine", "wait_all", "is_naive"]

register_env("MXNET_ENGINE_TYPE", "ThreadedEnginePerDevice", str,
             "Engine type; 'NaiveEngine' synchronises the device after "
             "every op of the nd registry.")


class Engine:
    """Process-wide engine singleton (MXNet's ``Engine::Get()``)."""

    def __init__(self):
        self._type = get_env("MXNET_ENGINE_TYPE")
        self.is_naive = self._type == "NaiveEngine"
        self.waits = 0
        self.host_reads = 0
        self._listeners = []
        self.hooked = self.is_naive

    @property
    def engine_type(self) -> str:
        return self._type

    def set_engine_type(self, name: str) -> None:
        self.wait_all()
        self._type = name
        self.is_naive = name == "NaiveEngine"
        self.hooked = self.is_naive or bool(self._listeners)

    def add_listener(self, fn) -> None:
        """Call ``fn(op_name, outputs, dispatch_us)`` after each op of the
        registry (``dispatch_us``: the host time the op took to queue)."""
        self._listeners.append(fn)
        self.hooked = True

    def remove_listener(self, fn) -> None:
        if fn in self._listeners:
            self._listeners.remove(fn)
        self.hooked = self.is_naive or bool(self._listeners)

    def on_op(self, name: str, outputs, dispatch_us: float = 0.0) -> None:
        """Run after each op of the registry while ``hooked``: the
        listeners, then, under NaiveEngine, a wait for the op's device."""
        for fn in list(self._listeners):
            fn(name, outputs, dispatch_us)
        if self.is_naive:
            for t in outputs:
                if isinstance(t, torch.Tensor) and t.is_cuda:
                    torch.cuda.synchronize(t.device)
                    break

    def wait_all(self) -> None:
        """Block until every op queued on every CUDA device has run."""
        self.waits += 1
        if torch.cuda.is_initialized():
            for i in range(torch.cuda.device_count()):
                torch.cuda.synchronize(i)

    def wait_for(self, tensor: torch.Tensor) -> None:
        """Block until the ops queued on ``tensor``'s device (its current
        stream) have run."""
        self.waits += 1
        if tensor.is_cuda:
            torch.cuda.current_stream(tensor.device).synchronize()

    def stats(self) -> dict:
        return {"engine_type": self._type, "waits": self.waits,
                "host_reads": self.host_reads}

    def reset_stats(self) -> None:
        self.waits = 0
        self.host_reads = 0


_engine = Engine()


def engine() -> Engine:
    return _engine


def is_naive() -> bool:
    return _engine.is_naive


def wait_all() -> None:
    _engine.wait_all()
