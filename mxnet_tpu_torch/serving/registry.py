"""Model registry: N named servers behind one admission layer.

Counterpart of ``mxnet_tpu/serving/registry.py``.  The registry owns the
name -> server binding and what hangs off it:

- **per-model metrics**: every entry gets its own serving spine under
  ``serving.model.<name>.*`` (socket-to-socket request latency, admits,
  429s, sheds, TTFT for generation models); the model label is carried
  in the metric name;
- **priorities, SLOs and load shedding**: each model carries an integer
  priority (higher = more important).  The registry holds one *shed
  level*; a request for a model whose priority is below it is rejected
  at the door with :class:`ServerOverloaded` (HTTP 429) before it
  touches the model's own admission queue;
- **lifecycle**: ``load()`` starts (and optionally warms: builds and
  captures every graph) a server; ``unload()`` drains and removes;
  ``swap()`` is the rolling blue/green weight swap
  (:meth:`ModelServer.swap_block`): no request drops.

Knobs: ``MXTPU_FRONTEND_PRIORITY`` (default model priority),
``MXTPU_FRONTEND_SLO_MS`` (default per-model p99 SLO in ms, the budget the
``tuning.SloController`` defends; 0 = none).
"""
from __future__ import annotations

import re
import threading
import time
from typing import Dict, List, Optional

from ..base import get_env
from ..observability.registry import registry as _metrics
from .batcher import ServerOverloaded, ServingError
from .server import GenerationServer

__all__ = ["ModelEntry", "ModelRegistry", "UnknownModel",
           "MODEL_METRIC_PREFIX"]

PRIORITY_ENV = "MXTPU_FRONTEND_PRIORITY"
SLO_MS_ENV = "MXTPU_FRONTEND_SLO_MS"

#: metric-name namespace of the per-model metrics
MODEL_METRIC_PREFIX = "serving.model."

_NAME_OK = re.compile(r"^[A-Za-z0-9_.\-]{1,64}$")


class UnknownModel(ServingError):
    """Request for a model name the registry does not hold (404)."""


def _metric_component(name: str) -> str:
    """Model name → one dotted-metric-name component (``[a-z0-9_]+``):
    lowercased, every other character folded to ``_``."""
    comp = re.sub(r"[^a-z0-9_]", "_", name.lower())
    return comp or "_"


class ModelEntry:
    """One registered model: the server, its admission policy, and its
    per-model metric spine (socket-to-socket latency: the server's own
    ``serving.request_us`` measures enqueue to done, this what the client
    saw, which is what an SLO is written against)."""

    def __init__(self, name: str, server, *, priority: int,
                 slo_ms: float):
        self.name = name
        self.server = server
        self.kind = ("generate" if isinstance(server, GenerationServer)
                     else "predict")
        self.priority = int(priority)
        self.slo_ms = float(slo_ms)
        self.status = "loading"
        self.loaded_at = time.time()
        self.swaps = 0
        m = MODEL_METRIC_PREFIX + _metric_component(name)
        reg = _metrics()
        self.h_request = reg.histogram(
            m + ".request_us",
            help=f"model {name}: socket-to-socket request latency "
                 f"(the SLO signal)")
        self.c_requests = reg.counter(
            m + ".requests", help=f"model {name}: requests admitted")
        self.c_done = reg.counter(
            m + ".requests_done",
            help=f"model {name}: requests completed ok")
        self.c_rejected = reg.counter(
            m + ".rejected_429",
            help=f"model {name}: requests rejected by the model's own "
                 f"admission queue (backpressure 429)")
        self.c_shed = reg.counter(
            m + ".shed",
            help=f"model {name}: requests shed by the registry's "
                 f"priority gate (SLO-protective 429)")
        if self.kind == "generate":
            self.h_ttft = reg.histogram(
                m + ".ttft_us",
                help=f"model {name}: socket-measured time to first "
                     f"streamed token")
        else:
            self.h_ttft = None

    def describe(self) -> dict:
        d = {
            "name": self.name,
            "kind": self.kind,
            "status": self.status,
            "priority": self.priority,
            "slo_ms": self.slo_ms,
            "swaps": self.swaps,
            "stats": self.server.stats(),
        }
        return d


class ModelRegistry:
    """Named :class:`ModelServer`/:class:`GenerationServer` instances
    behind one priority-aware admission gate (see module docstring)."""

    def __init__(self):
        self._models: Dict[str, ModelEntry] = {}
        self._lock = threading.Lock()
        self._shed_level = 0
        self._g_shed = _metrics().gauge(
            "serving.shed_priority",
            help="registry shed level: requests for models with "
                 "priority BELOW this are 429'd at the door (0 = "
                 "nothing shed)")
        self._g_shed.set(0)
        self._g_models = _metrics().gauge(
            "serving.models_loaded", help="models resident in the "
                                          "registry")
        self._g_models.set(0)

    # -- lifecycle -----------------------------------------------------
    def load(self, name: str, server, *, priority: Optional[int] = None,
             slo_ms: Optional[float] = None, start: bool = True,
             warm=None) -> ModelEntry:
        """Register (and by default start) a server under ``name``.

        ``warm`` builds graphs before the model goes ready: for a
        :class:`ModelServer` pass example sample tuples (forwarded to
        :meth:`ModelServer.warmup`); for a :class:`GenerationServer` pass
        True."""
        if not _NAME_OK.match(name or ""):
            raise ServingError(
                f"model name {name!r} must match {_NAME_OK.pattern}")
        if priority is None:
            priority = int(get_env(PRIORITY_ENV))
        if slo_ms is None:
            slo_ms = float(get_env(SLO_MS_ENV))
        entry = ModelEntry(name, server, priority=priority,
                           slo_ms=slo_ms)
        with self._lock:
            if name in self._models:
                raise ServingError(
                    f"model {name!r} is already loaded (swap() replaces "
                    f"weights; unload() first to replace the server)")
            self._models[name] = entry
            self._g_models.set(len(self._models))
        try:
            if start:
                server.start()
            if warm is not None:
                if entry.kind == "generate":
                    server.warmup()
                elif warm is not True:
                    server.warmup(*warm)
            entry.status = "ready"
        except BaseException:
            with self._lock:
                self._models.pop(name, None)
                self._g_models.set(len(self._models))
            raise
        return entry

    def unload(self, name: str, drain: bool = True,
               timeout: Optional[float] = None) -> None:
        """Drain (or shed, ``drain=False``) and remove one model."""
        with self._lock:
            entry = self._models.pop(name, None)
            self._g_models.set(len(self._models))
        if entry is None:
            raise UnknownModel(f"no model named {name!r}")
        entry.status = "unloading"
        entry.server.stop(drain=drain, timeout=timeout)
        entry.status = "unloaded"

    def stop_all(self, drain: bool = True,
                 timeout: Optional[float] = None) -> None:
        """Graceful-shutdown sweep: drain every resident server (the
        frontend's SIGTERM path fans out here)."""
        with self._lock:
            entries = list(self._models.values())
        for e in entries:
            e.status = "unloading"
            e.server.stop(drain=drain, timeout=timeout)
            e.status = "unloaded"

    # -- lookup --------------------------------------------------------
    def get(self, name: str) -> ModelEntry:
        with self._lock:
            entry = self._models.get(name)
        if entry is None:
            raise UnknownModel(f"no model named {name!r}")
        return entry

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._models)

    def entries(self) -> List[ModelEntry]:
        with self._lock:
            return [self._models[n] for n in sorted(self._models)]

    def describe(self) -> dict:
        return {"models": [e.describe() for e in self.entries()],
                "shed_level": self.shed_level}

    def ready(self) -> bool:
        """Readiness: at least one model, all of them ready."""
        entries = self.entries()
        return bool(entries) and all(e.status == "ready"
                                     for e in entries)

    # -- the priority admission gate -----------------------------------
    @property
    def shed_level(self) -> int:
        return self._shed_level

    def set_shed_level(self, level: int) -> None:
        """Requests for models with ``priority < level`` are 429'd at
        the door (the SloController's shedding actuator).  0 sheds
        nothing."""
        self._shed_level = max(0, int(level))
        self._g_shed.set(self._shed_level)

    def priorities(self) -> List[int]:
        """Distinct priorities resident, ascending (the SloController's
        shed ladder)."""
        return sorted({e.priority for e in self.entries()})

    def admit(self, entry: ModelEntry) -> None:
        """The registry-level gate, called before the model's own
        admission queue: shed low-priority work while the level is
        raised."""
        if entry.priority < self._shed_level:
            entry.c_shed.inc()
            raise ServerOverloaded(
                f"model {entry.name!r} (priority {entry.priority}) shed "
                f"at level {self._shed_level} — the host is protecting "
                f"higher-priority SLOs; retry with backoff (429)")

    # -- blue/green ----------------------------------------------------
    def swap(self, name: str, new_block) -> int:
        """Rolling blue/green weight swap on a predict model (see
        :meth:`ModelServer.swap_block`).  Traffic keeps flowing on the
        old graphs while the new ones are built; the flip is atomic and
        drops nothing.  Returns the graph count of the new set."""
        entry = self.get(name)
        if entry.kind != "predict":
            raise ServingError(
                "blue/green swap is a ModelServer operation; reload "
                "generation models via unload()+load()")
        entry.status = "swapping"
        try:
            n = entry.server.swap_block(new_block)
            entry.swaps += 1
        finally:
            entry.status = "ready"
        return n
