"""Causal tracing: end-to-end request traces over the metrics spine.

Counterpart of ``mxnet_tpu/observability/tracing.py``.  :mod:`.trace`
measures *how long* things take (spans feed histograms); this module
records *what caused what*.  A **trace** is a tree of spans sharing one
``trace_id``: a serving request, the batch assembly it rode, the
dispatch and the readback of that batch, stitched across the threads
that carried it, so a p99 outlier resolves to the one execution that
produced it.

Context model (W3C trace-context shaped):

- every span carries ``trace_id`` (32 hex) / ``span_id`` (16 hex) /
  ``parent_id``; the ACTIVE span propagates via a :mod:`contextvars`
  ContextVar, so nesting works across ``with`` scopes and executor
  context copies without plumbing;
- cross-thread and cross-process edges carry the W3C ``traceparent``
  string (``00-<trace_id>-<span_id>-01``): :func:`traceparent` exports
  the active context, :func:`parse_traceparent` + :func:`activate`
  adopt a remote one (the HTTP front door parents a request's root on
  the caller's header this way);
- **deterministic ids**: :func:`deterministic_trace_id` derives a trace
  id from shared state, so processes computing it from the same parts
  land in one trace with no handshake.

Sampling and cost: everything is knob-gated (``MXTPU_TRACE``, default
off).  :meth:`Tracer.enabled` is memoized against the raw environ entry
(one dict hit a probe), instrumented call sites guard on an
already-``None`` per-object context before touching the tracer, and
span begin/finish never formats, logs or touches a device tensor.
**Head sampling** (``MXTPU_TRACE_SAMPLE`` = N) starts a new ROOT trace
for 1 in N decisions; children of a sampled trace are always recorded.
Completed spans land in a bounded ring (``MXTPU_TRACE_RING``) and, with
``MXTPU_TRACE_JSONL`` set, in a size-rotated JSONL file.

Export: :meth:`Tracer.chrome_events` renders the ring as chrome-trace
events with **flow arrows** (``ph: s/f``) from parent to child and from
link sources (a batch span links every member request); ``mx.profiler``
merges them into its timeline, and :func:`chrome_trace_from_spans`
writes a standalone one.

Exemplars: while tracing is enabled every
:meth:`~.registry.Histogram.observe` records the active ``trace_id``
into the observed bucket (last-K, OpenMetrics exemplar syntax on the
Prometheus endpoint).
"""
from __future__ import annotations

import contextvars
import hashlib
import json
import os
import random
import threading
from collections import deque
from time import perf_counter, time as _wall
from typing import Dict, List, Optional, Tuple

from ..base import get_env
from .registry import host_id, registry, set_exemplar_trace_hook

__all__ = ["Span", "RemoteContext", "Tracer", "tracer", "current",
           "traceparent", "parse_traceparent", "activate", "now",
           "deterministic_trace_id", "gen_trace_id", "record_child",
           "chrome_trace_from_spans", "chrome_events_from_spans",
           "thread_spans", "enable_thread_span_tracking",
           "disable_thread_span_tracking",
           "TRACE_ENV", "TRACE_SAMPLE_ENV", "TRACE_RING_ENV",
           "TRACE_JSONL_ENV"]

TRACE_ENV = "MXTPU_TRACE"
TRACE_SAMPLE_ENV = "MXTPU_TRACE_SAMPLE"
TRACE_RING_ENV = "MXTPU_TRACE_RING"
TRACE_JSONL_ENV = "MXTPU_TRACE_JSONL"

#: exemplar depth per histogram bucket (the "last-K")
EXEMPLAR_K = 4

# os.environ's decoded-bytes dict (posix): the enabled probe runs on
# serving dispatch roots, where os.environ.get's key encode is real
# money
_ENV_DATA = getattr(os.environ, "_data", None) if os.name == "posix" \
    else None
if not isinstance(_ENV_DATA, dict):
    _ENV_DATA = None

_TRACE_KEY_B = TRACE_ENV.encode()
_TRACE_SAMPLE_KEY_B = TRACE_SAMPLE_ENV.encode()


def _raw_env(key_bytes: bytes, key_str: str):
    """Raw environ entry for a DECLARED knob: the value is only ever
    compared against a memo — parsing goes through get_env when the raw
    entry actually changed."""
    if _ENV_DATA is not None:
        return _ENV_DATA.get(key_bytes)
    return os.environ.get(key_str)

# the ACTIVE span for the current logical context.  contextvars, not a
# thread-local stack: executor-copied contexts and explicit activate()
# scopes compose, and a plain ContextVar.get() is the whole cost of the
# not-tracing probe.
_active: contextvars.ContextVar = contextvars.ContextVar(
    "mxtpu_trace_span", default=None)

# Cross-thread view of the active spans, for the stack sampler and the
# watchdog postmortem: a ContextVar is unreadable from another thread,
# so while introspection is enabled (refcounted — the sampler daemon,
# the watchdog, an on-demand /debug/profile window) every activation
# site mirrors the span into this ident-keyed dict.  OFF is the normal
# state and costs one module-global bool read per span activation; the
# dict itself needs no lock — each thread writes only its own ident
# (GIL-atomic dict ops) and readers only snapshot via dict copy.
_track_spans = False
_track_refs = 0
_track_lock = threading.Lock()
_thread_spans: Dict[int, object] = {}


def enable_thread_span_tracking() -> None:
    """Start mirroring span activations into the cross-thread map
    (refcounted: pairs with :func:`disable_thread_span_tracking`)."""
    global _track_spans, _track_refs
    with _track_lock:
        _track_refs += 1
        _track_spans = True


def disable_thread_span_tracking() -> None:
    """Drop one tracking ref; the map stops updating (and is cleared)
    when the last consumer detaches."""
    global _track_spans, _track_refs
    off = False
    with _track_lock:
        _track_refs = max(0, _track_refs - 1)
        if _track_refs == 0:
            _track_spans = False
            off = True
    if off:
        _thread_spans.clear()


def thread_spans() -> Dict[int, object]:
    """Snapshot of thread ident → active Span/RemoteContext.  Empty
    unless tracking is enabled — callers treat a missing ident as "no
    active span"."""
    return dict(_thread_spans)


def _set_active(obj):
    """Install ``obj`` as the active context AND mirror it into the
    cross-thread map when tracking is on.  Returns the reset token."""
    token = _active.set(obj)
    if _track_spans:
        _thread_spans[threading.get_ident()] = obj
    return token


def _reset_active(token) -> None:
    """Undo a :func:`_set_active` (ValueError = crossed a context
    boundary: clearing beats leaking the span into unrelated work)."""
    try:
        _active.reset(token)
    except ValueError:
        _active.set(None)
    if _track_spans:
        cur = _active.get()
        ident = threading.get_ident()
        if cur is None:
            _thread_spans.pop(ident, None)
        else:
            _thread_spans[ident] = cur


_rng = random.Random()
_rng.seed(int.from_bytes(os.urandom(8), "big"))
_rng_lock = threading.Lock()


def _gen_id(bits: int) -> str:
    with _rng_lock:
        return format(_rng.getrandbits(bits), f"0{bits // 4}x")


def gen_trace_id() -> str:
    """A fresh random 32-hex trace id — for rare always-traced events
    (fleet re-forms) that bypass head sampling by passing an explicit
    id to :meth:`Tracer.begin`."""
    return _gen_id(128)


def deterministic_trace_id(*parts) -> str:
    """A 32-hex trace id derived purely from ``parts`` — the stitch key
    for fleet-lockstep events: every host computing
    ``deterministic_trace_id(fence, step)`` lands in the SAME trace with
    no cross-host handshake (the lockstep is the causality)."""
    h = hashlib.sha256("\x1f".join(str(p) for p in parts).encode())
    return h.hexdigest()[:32]


class RemoteContext:
    """A parent context received from another host/thread (a parsed
    ``traceparent``): just the two ids, usable anywhere a local
    :class:`Span` is accepted as ``parent``."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id

    def __repr__(self) -> str:
        return f"RemoteContext({self.trace_id}, {self.span_id})"


class Span:
    """One recorded unit of work.  Usable three ways:

    - ``with tracer().begin("name") as sp:`` — activates for the body,
      records on exit;
    - explicit lifecycle: ``sp = begin(..., activate=False)`` ...
      ``sp.finish()`` — the serving request shape (begin on submit,
      finish on completion, possibly on another thread);
    - retroactive: ``begin(..., t0=..., activate=False)`` then
      ``finish(t_end=...)`` — attributing already-measured work (the
      loader wait that preceded a step) into the trace after the fact.

    ``link(ctx)`` records a non-parent causal edge (a batch span links
    every member request) — rendered as a chrome-trace flow arrow.
    """

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "t0_pc",
                 "t0_wall", "duration_us", "args", "links", "_tracer",
                 "_token", "_done")

    def __init__(self, tracer: "Tracer", name: str, trace_id: str,
                 parent_id: Optional[str], t0_pc: Optional[float],
                 args: Optional[dict]):
        self.name = name
        self.trace_id = trace_id
        self.span_id = _gen_id(64)
        self.parent_id = parent_id
        pc = perf_counter()
        self.t0_pc = pc if t0_pc is None else float(t0_pc)
        # wall anchor derived from the SAME instant so pc and wall views
        # of one span can never disagree (cross-host merges use wall)
        self.t0_wall = _wall() - (pc - self.t0_pc)
        self.duration_us = 0.0
        self.args = args
        self.links: Optional[List[Tuple[str, str]]] = None
        self._tracer = tracer
        self._token = None
        self._done = False

    def link(self, ctx) -> None:
        """Record a causal (non-parent) edge from ``ctx`` to this span."""
        if ctx is None:
            return
        if self.links is None:
            self.links = []
        self.links.append((ctx.trace_id, ctx.span_id))

    def annotate(self, **kv) -> None:
        """Merge metadata into the span's args (postmortem context —
        never touches any histogram)."""
        if self.args is None:
            self.args = {}
        self.args.update(kv)

    def adopt(self, ctx) -> None:
        """Re-parent this (still-open) span under a remote context — the
        membership re-form uses it once the round's canonical
        traceparent is known (the lowest-rank view's), so every
        survivor's round lands in ONE trace no matter who opened it."""
        if ctx is None or self._done:
            return
        self.trace_id = ctx.trace_id
        self.parent_id = ctx.span_id

    @property
    def traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-01"

    # -- context-manager / lifecycle ----------------------------------------
    def __enter__(self) -> "Span":
        # idempotent: begin(activate=True) already installed the
        # context — a second set here would orphan the first token and
        # leak the span past its own `with` block
        if self._token is None and not self._done:
            self._token = _set_active(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            self.annotate(error=exc_type.__name__)
        self.finish()

    def finish(self, t_end: Optional[float] = None) -> None:
        """Close and record the span (idempotent).  ``t_end`` is a
        ``tracing.now()`` timestamp for retroactive spans."""
        if self._done:
            return
        self._done = True
        end = perf_counter() if t_end is None else float(t_end)
        self.duration_us = max(0.0, (end - self.t0_pc) * 1e6)
        if self._token is not None:
            _reset_active(self._token)
            self._token = None
        self._tracer._record(self)


class Tracer:
    """Process tracer: sampling decisions + the bounded completed-span
    ring + the JSONL stream.  One process-global instance
    (:func:`tracer`); tests may build private ones."""

    def __init__(self, ring: Optional[int] = None,
                 jsonl: Optional[str] = None):
        # config memo fields are GIL-plain (never under the lock): the
        # enabled/sample probes run on hot roots and must stay dict-hit
        # cheap; ring/jsonl state below is lock-protected
        self._raw_on: object = object()
        self._on = False
        self._raw_sample: object = object()
        self._sample = 1
        self._root_seq = 0
        self._ring_cap = ring
        self._jsonl_path = jsonl
        self._jsonl_max = 16 * 1024 * 1024
        self._configured = False
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(1, ring or 2048))
        self._buf: List[str] = []
        self._lanes: Dict[int, int] = {}
        self._lane_names: Dict[int, str] = {}
        reg = registry()
        self._c_spans = reg.counter(
            "tracing.spans_recorded",
            help="completed spans recorded into the trace ring")
        self._c_sampled = reg.counter(
            "tracing.roots_sampled",
            help="new root traces started (head sampling kept them)")
        self._c_unsampled = reg.counter(
            "tracing.roots_unsampled",
            help="root candidates dropped by 1-in-N head sampling")

    # -- knobs ---------------------------------------------------------------
    @property
    def enabled(self) -> bool:
        """Live, memoized ``MXTPU_TRACE``: re-parsed only when the raw
        environ entry changes (this property is the whole cost of the
        tracing-off path on instrumented hot roots)."""
        raw = _raw_env(_TRACE_KEY_B, TRACE_ENV)
        if raw != self._raw_on:
            self._raw_on = raw
            self._on = bool(get_env(TRACE_ENV))
            if self._on and not self._configured:
                self._configure()
        return self._on

    @property
    def sample_n(self) -> int:
        """Live, memoized ``MXTPU_TRACE_SAMPLE`` (1 = every root)."""
        raw = _raw_env(_TRACE_SAMPLE_KEY_B, TRACE_SAMPLE_ENV)
        if raw != self._raw_sample:
            self._raw_sample = raw
            self._sample = max(1, int(get_env(TRACE_SAMPLE_ENV)))
        return self._sample

    def _configure(self) -> None:
        """Resolve ring depth + JSONL path from the env (runs on the
        first off→on transition; constructor arguments pin them for
        test instances)."""
        self._configured = True
        with self._lock:
            if self._ring_cap is None:
                cap = max(1, int(get_env(TRACE_RING_ENV)))
                self._ring = deque(self._ring, maxlen=cap)
            if self._jsonl_path is None:
                path = str(get_env(TRACE_JSONL_ENV)).strip()
                self._jsonl_path = path or ""
            jsonl = self._jsonl_path
        if jsonl:
            import atexit
            atexit.register(self.flush_jsonl)

    def sampled_index(self, i: int) -> bool:
        """Deterministic head-sampling for fleet-lockstep roots: keep
        index ``i`` iff ``i % sample_n == 0`` — every host computes the
        same verdict for the same step, so sampled step traces are
        always whole across the fleet."""
        if not self.enabled:
            return False
        return int(i) % self.sample_n == 0

    # -- span creation -------------------------------------------------------
    def begin(self, name: str, *, parent=None, trace_id: Optional[str]
              = None, t0: Optional[float] = None, args: Optional[dict]
              = None, activate: bool = True) -> Optional[Span]:
        """Start a span, or return None (record nothing) when tracing is
        off or head sampling dropped a new root.

        - ``parent`` given (a Span or RemoteContext): a child — always
          recorded (sampling happened at the root).
        - no parent, active context present: child of it.
        - no parent, no context, ``trace_id`` given: a deterministic
          root — the CALLER made the sampling decision
          (:meth:`sampled_index`).
        - no parent, no context, no trace_id: a fresh root, subject to
          1-in-N head sampling.

        ``activate=False`` skips the contextvar install (explicit
        lifecycle: serving requests, retroactive children).
        """
        if not self.enabled:
            return None
        if parent is None:
            parent = _active.get()
        if parent is not None:
            sp = Span(self, name, parent.trace_id, parent.span_id, t0,
                      args)
        elif trace_id is not None:
            self._c_sampled.inc()
            sp = Span(self, name, trace_id, None, t0, args)
        else:
            # root sequence under the lock: concurrent submit threads
            # racing a bare += would drift the 1-in-N ratio (and inc(),
            # not a plain .n bump — many threads reach this)
            with self._lock:
                self._root_seq += 1
                seq = self._root_seq
            n = self.sample_n
            if n > 1 and seq % n:
                self._c_unsampled.inc()
                return None
            self._c_sampled.inc()
            sp = Span(self, name, _gen_id(128), None, t0, args)
        if activate:
            sp._token = _set_active(sp)
        return sp

    def record_child(self, name: str, t_end_pc: float, dur_us: float,
                     args: Optional[dict]) -> None:
        """Retroactively record an already-measured unit as a child of
        the ACTIVE span (the :class:`.trace.span`
        exit hook: every histogram span inside a traced region lands in
        the trace for free).  No active context → no-op."""
        parent = _active.get()
        if parent is None:
            return
        sp = Span(self, name, parent.trace_id, parent.span_id,
                  t_end_pc - dur_us / 1e6, args)
        sp._done = True
        sp.duration_us = dur_us
        self._record(sp)

    # -- recording -----------------------------------------------------------
    def _lane_locked(self, ident: int) -> int:
        lane = self._lanes.get(ident)
        if lane is None:
            lane = len(self._lanes)
            self._lanes[ident] = lane
            self._lane_names[lane] = threading.current_thread().name
        return lane

    def _record(self, sp: Span) -> None:
        rec = {
            "name": sp.name,
            "trace_id": sp.trace_id,
            "span_id": sp.span_id,
            "parent_id": sp.parent_id,
            "host": host_id(),
            "t0_pc": sp.t0_pc,
            "t0_wall": round(sp.t0_wall, 6),
            "dur_us": round(sp.duration_us, 1),
        }
        if sp.args:
            rec["args"] = sp.args
        if sp.links:
            rec["links"] = sp.links
        line = None
        with self._lock:
            rec["lane"] = self._lane_locked(threading.get_ident())
            self._ring.append(rec)
            if self._jsonl_path:
                self._buf.append(json.dumps(rec))
                if len(self._buf) >= 64:
                    line = "\n".join(self._buf) + "\n"
                    self._buf = []
        self._c_spans.inc()
        if line is not None:
            self._write_jsonl(line)

    def _write_jsonl(self, chunk: str) -> None:
        path = self._jsonl_path
        try:
            if os.path.exists(path) and \
                    os.path.getsize(path) + len(chunk) > self._jsonl_max:
                os.replace(path, path + ".1")   # one rotation generation
            with open(path, "a") as f:
                f.write(chunk)
        except OSError:
            pass   # tracing must never take down the traced job

    def flush_jsonl(self) -> None:
        """Write any buffered JSONL lines now (atexit / test sync)."""
        with self._lock:
            if not (self._jsonl_path and self._buf):
                return
            chunk = "\n".join(self._buf) + "\n"
            self._buf = []
        self._write_jsonl(chunk)

    # -- consumption ---------------------------------------------------------
    def spans(self) -> List[dict]:
        with self._lock:
            return list(self._ring)

    def find(self, trace_id: str) -> List[dict]:
        """Every ring span belonging to ``trace_id`` (exemplar
        resolution: histogram bucket → trace_id → the actual spans)."""
        with self._lock:
            return [s for s in self._ring if s["trace_id"] == trace_id]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._buf = []

    def lane_names(self) -> Dict[int, str]:
        with self._lock:
            return dict(self._lane_names)

    def chrome_events(self, base_pc: Optional[float] = None,
                      tid_offset: int = 0) -> List[dict]:
        """The ring as chrome-trace events (see
        :func:`chrome_trace_from_spans`).  ``base_pc`` renders on the
        perf_counter clock relative to that origin (the profiler's
        unified timeline); default is the wall clock (standalone and
        cross-host merges)."""
        return chrome_events_from_spans(self.spans(), base_pc=base_pc,
                                        tid_offset=tid_offset)

    def dump_chrome_trace(self, path: str) -> str:
        """Write the ring as a standalone chrome-trace JSON file."""
        return chrome_trace_from_spans(self.spans(), path)


def chrome_events_from_spans(spans: List[dict],
                             base_pc: Optional[float] = None,
                             tid_offset: int = 0) -> List[dict]:
    """Chrome-trace events for a span list (possibly merged from many
    hosts' rings/JSONL dumps): one ``X`` duration event per span on
    ``pid = host`` / ``tid = recording-thread lane``, plus **flow
    events** — an arrow from each parent span to each child and from
    every link source (e.g. member requests) to the linking span.
    Cross-host edges just work: flow events bind by id, not pid."""

    def ts(s):
        if base_pc is not None:
            return (s["t0_pc"] - base_pc) * 1e6
        return s["t0_wall"] * 1e6

    by_span = {s["span_id"]: s for s in spans}
    events: List[dict] = []
    for s in spans:
        t0 = ts(s)
        args = {"trace_id": s["trace_id"], "span_id": s["span_id"]}
        if s.get("args"):
            args.update(s["args"])
        tid = tid_offset + s.get("lane", 0)
        events.append({"name": s["name"], "ph": "X", "cat": "trace",
                       "pid": s.get("host", 0), "tid": tid, "ts": t0,
                       "dur": max(s["dur_us"], 0.1), "args": args})
        edges = []
        parent = by_span.get(s.get("parent_id") or "")
        if parent is not None:
            edges.append((parent, "causes"))
        for _lt, ls in s.get("links") or ():
            # links may cross TRACES (a batch span links member
            # requests living in their own traces) — presence of the
            # source span is the only requirement for the arrow
            src = by_span.get(ls)
            if src is not None:
                edges.append((src, "links"))
        for idx, (src, kind) in enumerate(edges):
            # one flow id per EDGE: chrome/perfetto bind s->f pairs by
            # (cat, id), so a span with a parent edge plus N link edges
            # sharing one id would merge into a garbled chain
            fid = (int(s["span_id"][:11] or "0", 16) << 4) | (idx & 15)
            src_tid = tid_offset + src.get("lane", 0)
            events.append({"name": kind, "ph": "s", "cat": "trace",
                           "id": fid, "pid": src.get("host", 0),
                           "tid": src_tid, "ts": ts(src)})
            events.append({"name": kind, "ph": "f", "bp": "e",
                           "cat": "trace", "id": fid,
                           "pid": s.get("host", 0), "tid": tid,
                           "ts": max(t0, ts(src))})
    return events


def chrome_trace_from_spans(spans: List[dict], path: str) -> str:
    """Write merged span records as a standalone chrome-trace file
    (``pid = host`` with process_name metadata) — the cross-host
    postmortem: concatenate the hosts' JSONL dumps, load one list, call
    this, open in ``chrome://tracing`` / Perfetto."""
    meta = [{"name": "process_name", "ph": "M", "pid": h,
             "args": {"name": f"host {h}"}}
            for h in sorted({s.get("host", 0) for s in spans})]
    payload = {"traceEvents": meta + chrome_events_from_spans(spans),
               "displayTimeUnit": "ms"}
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)
    return path


# -- module-level context surface --------------------------------------------

def current() -> Optional[Span]:
    """The active span in this context, or None."""
    return _active.get()


def now() -> float:
    """The tracing clock (``perf_counter`` seconds) — for callers that
    need span-comparable timestamps without tripping the timing-pair
    lint outside the observability layer."""
    return perf_counter()


def traceparent() -> Optional[str]:
    """W3C traceparent of the active context (``00-<trace>-<span>-01``),
    or None — what crosses to another thread or process."""
    sp = _active.get()
    return sp.traceparent if sp is not None else None


def parse_traceparent(header) -> Optional[RemoteContext]:
    """Parse a traceparent string into a :class:`RemoteContext`;
    malformed/empty input returns None (remote payloads are
    best-effort)."""
    if not header or not isinstance(header, str):
        return None
    parts = header.split("-")
    if len(parts) < 3:
        return None
    tid, sid = (parts[1], parts[2]) if parts[0] == "00" \
        else (parts[0], parts[1])
    if len(tid) != 32 or len(sid) != 16:
        return None
    try:
        int(tid, 16), int(sid, 16)
    except ValueError:
        return None
    return RemoteContext(tid, sid)


class activate:
    """``with activate(ctx):`` — install a (remote) parent context for
    the body, so spans begun inside join its trace.  ``ctx=None`` is a
    transparent no-op (pairs with :func:`parse_traceparent`)."""

    __slots__ = ("_ctx", "_token")

    def __init__(self, ctx):
        self._ctx = ctx
        self._token = None

    def __enter__(self):
        if self._ctx is not None:
            self._token = _set_active(self._ctx)
        return self._ctx

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._token is not None:
            _reset_active(self._token)


def record_child(name: str, t_end_pc: float, dur_us: float,
                 args: Optional[dict] = None) -> None:
    """Module-level fast path for :meth:`Tracer.record_child`: bail on
    the (overwhelmingly common) no-active-context case before touching
    the singleton — one ContextVar.get when tracing is idle."""
    if _active.get() is None:
        return
    tracer().record_child(name, t_end_pc, dur_us, args)


_tracer_lock = threading.Lock()
_tracer_inst: Optional[Tracer] = None


def _active_trace_id() -> Optional[str]:
    """The histogram exemplar hook: trace_id of the active span (or
    None) — one ContextVar.get per observe while tracing is enabled."""
    sp = _active.get()
    return sp.trace_id if sp is not None else None


def tracer() -> Tracer:
    """THE process-global tracer (the registry()/engine() idiom).  The
    first call installs the histogram exemplar hook, so exemplars
    record exactly when traces exist to point at."""
    global _tracer_inst
    inst = _tracer_inst
    if inst is not None:
        return inst
    with _tracer_lock:
        if _tracer_inst is None:
            _tracer_inst = Tracer()
            set_exemplar_trace_hook(_active_trace_id)
        return _tracer_inst
