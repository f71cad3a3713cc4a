"""Observability: one pull-based metrics surface, causal tracing, and
live introspection.

Counterpart of ``mxnet_tpu/observability``, under its module, metric,
span and knob names, so a dashboard or a postmortem tool reads either
package's output:

- :mod:`.registry`: ``Counter`` / ``Gauge`` / ``Histogram`` under
  namespaced names with one ``registry().snapshot()``, exemplars, and
  the fleet merge as pure functions over per-host states;
- :mod:`.trace`: ``span(name)`` context managers timing into
  histograms and echoing to span listeners (``mx.profiler``);
- :mod:`.tracing`: W3C-shaped causal traces (``MXTPU_TRACE*``), head
  sampling, a span ring, JSONL and Chrome traces with flow arrows;
- :mod:`.export`: the Prometheus text endpoint (``MXTPU_METRICS_PORT``),
  the JSONL writer (``MXTPU_METRICS_JSONL``) and the ``/debug/*``
  routes (``MXTPU_DEBUG_ENDPOINTS``);
- :mod:`.flight`: the crash flight recorder's four rings
  (``MXTPU_FLIGHT_STEPS`` / ``MXTPU_FLIGHT_PATH``);
- :mod:`.sampler`: the all-thread stack sampler
  (``MXTPU_PROF_SAMPLE_HZ``) with trace-tagged collapsed stacks;
- :mod:`.watchdog`: heartbeat touchpoints, the stall monitor and its
  one-shot postmortem (``MXTPU_WATCHDOG_FACTOR``), and the
  ``MXTPU_STACKS_SIGNAL`` stack dump.

Import discipline: this ``__init__`` loads only the dependency-free
:mod:`.registry`; the others load lazily on first attribute access,
because :mod:`.trace` and :mod:`.export` import the engine back.
"""
from __future__ import annotations

from .registry import (Counter, Gauge, Histogram, MetricsRegistry,
                       registry)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "registry",
           "trace", "export", "span", "flight", "tracing", "sampler",
           "watchdog"]


def __getattr__(name):
    # a static ``from .X import Y`` loads the submodule through the import
    # system, which binds it on this package (``from . import X`` would
    # look the attribute up here first and recurse)
    if name in ("trace", "span"):
        from .trace import span
        return span if name == "span" else globals()["trace"]
    if name == "export":
        from .export import debug_route  # noqa: F401
    elif name == "flight":
        from .flight import recorder  # noqa: F401
    elif name == "tracing":
        from .tracing import tracer  # noqa: F401
    elif name == "sampler":
        from .sampler import sampler  # noqa: F401
    elif name == "watchdog":
        from .watchdog import watchdog  # noqa: F401
    else:
        raise AttributeError(
            f"module 'mxnet_tpu_torch.observability' has no attribute "
            f"{name!r}")
    return globals()[name]
