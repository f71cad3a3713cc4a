"""Self-tuning runtime: feedback controllers on one timer thread.

Counterpart of ``mxnet_tpu/tuning``.  :mod:`.controllers` holds the
:class:`Controller` base (guard rails, hysteresis, dry run, every decision
recorded as ``tuning.*`` metrics and a flight-recorder tuning record) and
the controllers: :class:`~.controllers.PrefetchController`,
:class:`~.controllers.DevicePrefetchController` and
:class:`~.controllers.BatchWindowController` and
:class:`~.controllers.FleetGatherController` (the stock set,
:func:`standard_controllers`), and, constructed per live instance,
:class:`~.controllers.DecodeSlotController` (a ``GenerationServer``) and
:class:`~.controllers.SloController` (a ``ModelRegistry``).

All controllers share ONE daemon timer thread (:class:`TuningRuntime`),
ticking every ``MXTPU_TUNE_INTERVAL`` seconds.  Controllers are
tick-driven and wall-clock-free inside, so tests call
``controller.tick()`` / ``runtime().tick_all()`` directly against
synthetic metric streams.

Quick start::

    from mxnet_tpu_torch import tuning
    tuning.start()               # standard controllers, knob-gated
    ...                          # train / serve; knobs now self-tune
    tuning.stop()

Knobs: ``MXTPU_TUNE_INTERVAL``, ``MXTPU_TUNE_DRY_RUN``,
``MXTPU_TUNE_PREFETCH`` / ``_DEVICE_PREFETCH`` / ``_BATCH_WINDOW`` /
``_FLEET_GATHER`` / ``_DECODE_SLOTS`` / ``_SLO``.

Not ported: the JAX package's ``compile_cache`` (its executables
serialized to disk for the next process).  A captured CUDA graph does not
outlive its process, and the kernels' libraries already persist in
``build/``.
"""
from __future__ import annotations

import threading
import warnings
from typing import List, Optional

from ..base import get_env
from ..observability.registry import registry as _metrics_registry
from .controllers import (BatchWindowController, Controller, CounterDelta,
                          DecodeSlotController, DevicePrefetchController,
                          FleetGatherController, HistogramDelta,
                          PrefetchController, SloController)

__all__ = ["TuningRuntime", "runtime", "standard_controllers", "start",
           "stop", "Controller", "PrefetchController",
           "BatchWindowController", "DecodeSlotController",
           "DevicePrefetchController", "SloController",
           "FleetGatherController", "HistogramDelta",
           "CounterDelta"]

INTERVAL_ENV = "MXTPU_TUNE_INTERVAL"


class TuningRuntime:
    """The shared controller timer: one daemon thread ticking every
    registered controller each ``MXTPU_TUNE_INTERVAL`` seconds (read
    live per lap, so the cadence can be retuned on a running process).

    A controller whose ``tick()`` raises is counted
    (``tuning.errors``), warned about once, and *kept* — one misbehaving
    loop must not silence the others.  ``tick_all()`` is the
    synchronous entry tests drive directly."""

    def __init__(self):
        self._controllers: List[Controller] = []
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._warned: set = set()
        self._c_errors = _metrics_registry().counter(
            "tuning.errors",
            help="controller tick() exceptions (each warned once, "
                 "controller kept)")
        self._c_ticks = _metrics_registry().counter(
            "tuning.ticks", help="runtime timer-thread tick sweeps")

    # -- membership ----------------------------------------------------------
    def add(self, controller: Controller) -> Controller:
        with self._lock:
            self._controllers.append(controller)
        return controller

    def remove(self, controller: Controller) -> None:
        with self._lock:
            if controller in self._controllers:
                self._controllers.remove(controller)

    @property
    def controllers(self) -> List[Controller]:
        with self._lock:
            return list(self._controllers)

    # -- ticking -------------------------------------------------------------
    def tick_all(self) -> List[dict]:
        """One synchronous sweep over every controller; returns the
        non-None decision records (the timer thread discards them —
        they already landed in metrics + the flight ring)."""
        self._c_ticks.inc()
        out = []
        for c in self.controllers:
            try:
                d = c.tick()
            except Exception as e:   # noqa: BLE001 — one bad controller
                self._c_errors.inc()       # must not kill the sweep
                if c.name not in self._warned:
                    self._warned.add(c.name)
                    warnings.warn(
                        f"tuning controller {c.name!r} raised "
                        f"{type(e).__name__}: {e} (counted in "
                        f"tuning.errors; controller kept)",
                        RuntimeWarning, stacklevel=2)
                continue
            if d is not None:
                out.append(d)
        return out

    def _run(self) -> None:
        while True:
            interval = max(0.05, float(get_env(INTERVAL_ENV)))
            if self._stop.wait(interval):
                return
            self.tick_all()

    # -- lifecycle -----------------------------------------------------------
    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "TuningRuntime":
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="mxtpu-tuning", daemon=True)
            self._thread.start()
        return self

    def stop(self, timeout: Optional[float] = 5.0) -> None:
        with self._lock:
            thread, self._thread = self._thread, None
        if thread is not None:
            self._stop.set()
            thread.join(timeout)


_runtime_lock = threading.Lock()
_runtime_inst: Optional[TuningRuntime] = None


def runtime() -> TuningRuntime:
    """The process-global tuning runtime."""
    global _runtime_inst
    inst = _runtime_inst
    if inst is not None:
        return inst
    with _runtime_lock:
        if _runtime_inst is None:
            _runtime_inst = TuningRuntime()
        return _runtime_inst


def standard_controllers(**overrides) -> List[Controller]:
    """The stock controllers, each gated by its own ``MXTPU_TUNE_*``
    enable knob (evaluated live at every tick, so a controller can be
    switched off on a running process): the prefetch, batch-window,
    fleet-gather and device-prefetch controllers, in the JAX package's
    order.  Its ``BulkSizeController`` is left out (the port has no
    bulked dispatch, so ``MXNET_ENGINE_BULK_SIZE`` means nothing there).
    Keyword overrides are forwarded per controller:
    ``standard_controllers(batch_window={"vmax": 8000.0})``."""
    return [
        PrefetchController(**overrides.get("prefetch", {})),
        BatchWindowController(**overrides.get("batch_window", {})),
        FleetGatherController(**overrides.get("fleet_gather", {})),
        DevicePrefetchController(**overrides.get("device_prefetch", {})),
    ]


def start(controllers: Optional[List[Controller]] = None,
          **overrides) -> TuningRuntime:
    """Convenience: register ``controllers`` (default: the stock set)
    on the global runtime and start its timer thread."""
    rt = runtime()
    if controllers is None:
        if not rt.controllers:
            controllers = standard_controllers(**overrides)
        elif overrides:
            # silently dropping caller-specified guard rails would
            # leave the OLD rails in force while the operator believes
            # the new ones are — say so
            warnings.warn(
                "tuning.start(): the runtime already has controllers "
                "registered; the given overrides were NOT applied — "
                "remove the existing controllers (runtime().remove) or "
                "pass controllers= explicitly", RuntimeWarning,
                stacklevel=2)
    for c in controllers or ():
        rt.add(c)
    return rt.start()


def stop(timeout: Optional[float] = 5.0) -> None:
    runtime().stop(timeout)
