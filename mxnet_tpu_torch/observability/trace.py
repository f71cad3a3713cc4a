"""Lightweight trace spans over the metrics registry.

Counterpart of ``mxnet_tpu/observability/trace.py``.  ``span(name)`` is a
context manager that records the wall time of its body (in µs) into the
histogram ``name``.  Integration points:

- **Registry**: every exit observes the duration into
  ``registry().histogram(name)``, so percentiles surface through
  ``snapshot()`` and the Prometheus endpoint.
- **Causal tracing**: inside an active tracing context the span also
  lands in the trace as a child (:func:`.tracing.record_child`).
- **Span listeners** (``add_span_listener``): ``mx.profiler`` installs
  one, so spans appear on its chrome-trace timeline beside the op
  events; the engine's dispatch listeners also see a ``span:<name>``
  echo.

Spans nest: a thread-local stack tracks the active chain (``current()``
returns the innermost name, ``stack()`` the whole chain outermost
first), kept exception-safe.  Entering is a ``perf_counter()`` and a
list append; exiting a ``perf_counter()``, a pop and one histogram
observe.  A span measures host time: a CUDA kernel queued inside it may
still be running when it closes.
"""
from __future__ import annotations

import threading
from time import perf_counter
from typing import List, Optional

from ..engine import engine
from . import tracing as _tracing
from .registry import registry

__all__ = ["span", "current", "stack", "add_span_listener",
           "remove_span_listener"]

_tls = threading.local()

# span sinks: fn(name, t_end_seconds, duration_us, args) called on
# every span exit (``args`` is the span's metadata dict or None).  The
# profiler installs one so spans land on its chrome-trace timeline as
# duration events (pid=host, tid=thread, ``args`` carrying step/batch
# ids) next to op events.  Unlike an engine listener, a span listener
# does not make the op registry call the engine after every op.
_span_listeners: List = []


def add_span_listener(fn) -> None:
    """Install a span sink: ``fn(name, t_end, duration_us, args)`` with
    ``t_end`` in ``time.perf_counter()`` seconds and ``args`` the
    span's metadata dict (or None)."""
    if fn not in _span_listeners:
        _span_listeners.append(fn)


def remove_span_listener(fn) -> None:
    if fn in _span_listeners:
        _span_listeners.remove(fn)


def _stack() -> List[str]:
    s = getattr(_tls, "stack", None)
    if s is None:
        s = _tls.stack = []
    return s


def current() -> Optional[str]:
    """Innermost active span name on this thread, or None."""
    s = getattr(_tls, "stack", None)
    return s[-1] if s else None


def stack() -> List[str]:
    """The active span chain on this thread, outermost first (a copy)."""
    return list(getattr(_tls, "stack", ()))


class span:
    """``with span("resilience.step_us"): ...`` — record the body's
    wall-time into the histogram of that name.

    ``histogram=False`` keeps the nesting/bookkeeping (and the profiler
    event) without creating a registry metric — for ad-hoc scoping.
    The measured duration is available afterwards as ``.duration_us``.

    ``args`` is an optional metadata dict (step number, batch id, ...):
    it never touches the histogram (labels would explode cardinality)
    but rides to span listeners, so the profiler surfaces it as the
    chrome-trace event's ``args`` — hover a step span in the timeline
    and see WHICH step it was.  Cost: one attribute store when unused.
    """

    __slots__ = ("name", "duration_us", "args", "t_end", "_t0",
                 "_record")

    def __init__(self, name: str, histogram: bool = True,
                 args: Optional[dict] = None):
        self.name = name
        self.duration_us = 0.0
        self.t_end = 0.0
        self.args = args
        self._record = histogram
        # create (or fetch) the histogram at construction, not exit —
        # name errors surface where the span is written, and __exit__
        # stays allocation-free
        if histogram:
            registry().histogram(name)

    def __enter__(self) -> "span":
        _stack().append(self.name)
        self._t0 = perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        t_end = self.t_end = perf_counter()
        self.duration_us = (t_end - self._t0) * 1e6
        s = getattr(_tls, "stack", None)
        if s:
            s.pop()
        if self._record:
            registry().get(self.name).observe(self.duration_us)
        # causal tracing: inside a traced region (an active tracing
        # context) every measured span ALSO lands in the trace as a
        # child, with no change at its call site.  Idle cost: one
        # ContextVar.get.
        _tracing.record_child(self.name, t_end, self.duration_us,
                              self.args)
        for fn in _span_listeners:
            # the profiler's timeline sink: proper duration events with
            # real start/end timestamps on the host/thread lanes (and
            # the span's args as chrome-trace event args)
            fn(self.name, t_end, self.duration_us, self.args)
        eng = engine()
        if eng._listeners:
            # monitors tapping raw engine dispatches still see the span
            # in the same event stream (the profiler ignores this echo —
            # it gets the real event through the span listener above)
            for fn in eng._listeners:
                fn(f"span:{self.name}", (), self.duration_us)
        return None
