"""Exporters: Prometheus text endpoint, JSONL periodic writer, and the
``/debug/*`` introspection routes.

Counterpart of ``mxnet_tpu/observability/export.py``; the text it writes
is the JAX package's byte for byte (metric names ``mxtpu_<dotted name>``,
per-model families with a ``model`` label, OpenMetrics exemplars on
request), so a dashboard reads either package.

- **Pull** (:class:`MetricsServer`): a stdlib ``http.server`` endpoint
  serving ``/metrics`` in the Prometheus text exposition format,
  ``/metrics.json``, and the ``/debug/*`` routes (:func:`debug_route`,
  also served by the serving ``HttpFrontend``).  Nothing listens unless
  the server is started or ``MXTPU_METRICS_PORT`` is set.
- **Push-to-disk** (:class:`JsonlWriter`): one JSON object per line,
  appended every ``interval`` seconds (or on ``write_now()``), with
  size-based rotation.  Env: ``MXTPU_METRICS_JSONL=<path>`` (+
  ``MXTPU_METRICS_INTERVAL`` seconds, default 60).

``maybe_start_from_env()`` wires both from the environment; the package
``__init__`` calls it at import when either knob is set.
``env_server()`` is the endpoint it started (``MXTPU_METRICS_PORT=0``
binds an ephemeral port, read back there) and ``stop_from_env()`` stops
both; these two are the port's own.
"""
from __future__ import annotations

import json
import os
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

from ..base import MXNetError, get_env, list_env
from .registry import (Counter, Gauge, Histogram, MetricsRegistry,
                       group_host_entries, last_host_states, registry,
                       state_cumulative_buckets)

__all__ = ["prometheus_text", "prometheus_text_aggregate",
           "aggregate_mode", "MetricsServer", "JsonlWriter",
           "maybe_start_from_env", "env_server", "stop_from_env",
           "debug_route", "debug_enabled",
           "DEBUG_ENDPOINTS_ENV"]

METRICS_PORT_ENV = "MXTPU_METRICS_PORT"
DEBUG_ENDPOINTS_ENV = "MXTPU_DEBUG_ENDPOINTS"
METRICS_JSONL_ENV = "MXTPU_METRICS_JSONL"
METRICS_INTERVAL_ENV = "MXTPU_METRICS_INTERVAL"
#: serve the FLEET view (per-host states, every series labeled
#: host="<process_index>") instead of the local registry.  Read live per
#: scrape.
METRICS_AGGREGATE_ENV = "MXTPU_METRICS_AGGREGATE"

#: every exported sample is prefixed so dashboards can scope on it
PROM_PREFIX = "mxtpu_"

_SANITIZE_RE = re.compile(r"[^a-zA-Z0-9_]")

#: per-model serving metrics (``serving.model.<name>.<metric>`` — see
#: :data:`..serving.registry.MODEL_METRIC_PREFIX`) re-render as
#: ONE Prometheus family per <metric> with a real ``model="<name>"``
#: label: ``mxtpu_serving_model_<metric>{model="<name>"}``.  The family
#: name keeps the ``model`` component so it can never collide with the
#: servers' own unlabeled ``mxtpu_serving_*`` spine (a family may only
#: carry one TYPE header per exposition).
_MODEL_METRIC_RE = re.compile(r"^serving\.model\.([a-z0-9_]+)\.(.+)$")
_MODEL_HELP_PREFIX_RE = re.compile(r"^model [^:]*: ")


def _prom_name(name: str) -> str:
    return PROM_PREFIX + _SANITIZE_RE.sub("_", name)


def _fmt(v: float) -> str:
    """Prometheus sample values: integers render bare, floats with
    repr-precision, +Inf spelled the Prometheus way."""
    if v == float("inf"):
        return "+Inf"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


def _help_line(pname: str, help_text: str) -> Optional[str]:
    if not help_text:
        return None
    escaped = help_text.replace("\\", "\\\\").replace("\n", "\\n")
    return f"# HELP {pname} {escaped}"


def prometheus_text(reg: Optional[MetricsRegistry] = None,
                    exemplars: bool = False) -> str:
    """The registry in Prometheus text exposition format (version 0.0.4):
    counters/gauges as single samples, histograms as cumulative
    ``_bucket{le=...}`` series plus ``_sum``/``_count``; ``# HELP``
    lines for metrics registered with a description.

    ``exemplars=True`` appends OpenMetrics exemplar suffixes to bucket
    lines — only legal in OpenMetrics-shaped output (the endpoint's
    explicit ``/metrics?exemplars=1`` opt-in, which it serves under the
    ``application/openmetrics-text`` content type with the ``# EOF``
    terminator); the classic 0.0.4 parser rejects a whole scrape
    containing them, so the default text format never carries any."""
    reg = reg if reg is not None else registry()
    lines = []
    # two passes: registry names sort with the model component BEFORE
    # the metric (serving.model.a.request_us, serving.model.a.requests,
    # serving.model.b.request_us, ...) but Prometheus requires all
    # samples of one family contiguous under a single TYPE header — so
    # per-model metrics are collected into families here and emitted
    # after the plain spine.
    families = {}                  # metric -> [(model, m)]
    for name in reg.names():
        m = reg.get(name)
        if m is None:                     # raced an (hypothetical) removal
            continue
        mm = _MODEL_METRIC_RE.match(name)
        if mm:
            families.setdefault(mm.group(2), []).append(
                (mm.group(1), m))
            continue
        pname = _prom_name(name)
        hl = _help_line(pname, m.help)
        if hl:
            lines.append(hl)
        if isinstance(m, Counter):
            lines.append(f"# TYPE {pname} counter")
            lines.append(f"{pname} {_fmt(m.n)}")
        elif isinstance(m, Gauge):
            lines.append(f"# TYPE {pname} gauge")
            lines.append(f"{pname} {_fmt(m.value)}")
        elif isinstance(m, Histogram):
            lines.append(f"# TYPE {pname} histogram")
            # OpenMetrics exemplars (negotiated scrapes only): a bucket
            # line carries the newest trace_id observed into it —
            # `# {trace_id="..."} <value> <ts>` — so the p99 bucket in
            # a dashboard resolves to a real trace in the span ring.
            # Empty when tracing is off.
            ex = m.exemplars() if exemplars else {}
            for bound, cum in m.cumulative_buckets():
                line = f'{pname}_bucket{{le="{_fmt(bound)}"}} {cum}'
                e = ex.get(bound)
                if e:
                    tid, val, ts = e[-1]
                    line += (f' # {{trace_id="{tid}"}} {_fmt(val)} '
                             f'{ts}')
                lines.append(line)
            lines.append(f"{pname}_sum {_fmt(m.total)}")
            lines.append(f"{pname}_count {m.count}")
    for metric in sorted(families):
        entries = families[metric]
        pname = _prom_name(f"serving.model.{metric}")
        # the per-entry help embeds the model name; the family header
        # is model-agnostic, so strip the "model <name>: " prefix
        help_text = next((_MODEL_HELP_PREFIX_RE.sub("", m.help)
                          for _, m in entries if m.help), "")
        hl = _help_line(pname, help_text)
        if hl:
            lines.append(hl)
        kind = entries[0][1]
        if isinstance(kind, Counter):
            lines.append(f"# TYPE {pname} counter")
            for model, m in entries:
                lines.append(f'{pname}{{model="{model}"}} {_fmt(m.n)}')
        elif isinstance(kind, Gauge):
            lines.append(f"# TYPE {pname} gauge")
            for model, m in entries:
                lines.append(
                    f'{pname}{{model="{model}"}} {_fmt(m.value)}')
        elif isinstance(kind, Histogram):
            lines.append(f"# TYPE {pname} histogram")
            for model, m in entries:
                ex = m.exemplars() if exemplars else {}
                for bound, cum in m.cumulative_buckets():
                    line = (f'{pname}_bucket{{model="{model}",'
                            f'le="{_fmt(bound)}"}} {cum}')
                    e = ex.get(bound)
                    if e:
                        tid, val, ts = e[-1]
                        line += (f' # {{trace_id="{tid}"}} '
                                 f'{_fmt(val)} {ts}')
                    lines.append(line)
                lines.append(
                    f'{pname}_sum{{model="{model}"}} {_fmt(m.total)}')
                lines.append(
                    f'{pname}_count{{model="{model}"}} {m.count}')
    return "\n".join(lines) + "\n"


def aggregate_mode() -> bool:
    """Live read of the ``MXTPU_METRICS_AGGREGATE`` opt-in."""
    return bool(get_env(METRICS_AGGREGATE_ENV))


def prometheus_text_aggregate(
        reg: Optional[MetricsRegistry] = None) -> str:
    """The FLEET view in Prometheus text format: this host's series read
    live plus every other host's from the most recent gather
    (``snapshot(all_hosts=True)``, a collective run at fleet sync points
    such as checkpoint boundaries, never from the scrape handler; or the
    ``FleetGatherController``'s barrier-free gather), each labeled
    ``host="<process_index>"``.  Cross-host aggregation (sums, merged
    quantiles) is PromQL's job — ``sum by (le)`` etc.  Before the first
    gather (or single-process) this serves the local host's series under
    its own host label."""
    lines = []
    for name, kind, entries in group_host_entries(last_host_states(reg)):
        pname = _prom_name(name)
        help_text = next((e["help"] for _, e in entries
                          if e.get("help")), "")
        hl = _help_line(pname, help_text)
        if hl:
            lines.append(hl)
        lines.append(f"# TYPE {pname} {kind}")
        for h, e in entries:
            if kind == "counter":
                lines.append(f'{pname}{{host="{h}"}} {_fmt(e["n"])}')
            elif kind == "gauge":
                lines.append(f'{pname}{{host="{h}"}} {_fmt(e["v"])}')
            elif kind == "histogram":
                for bound, cum in state_cumulative_buckets(e):
                    lines.append(
                        f'{pname}_bucket{{host="{h}",'
                        f'le="{_fmt(bound)}"}} {cum}')
                lines.append(
                    f'{pname}_sum{{host="{h}"}} {_fmt(e["total"])}')
                lines.append(
                    f'{pname}_count{{host="{h}"}} {e["count"]}')
    return "\n".join(lines) + "\n"


def debug_enabled() -> bool:
    """Live read of the ``MXTPU_DEBUG_ENDPOINTS`` opt-in."""
    return bool(get_env(DEBUG_ENDPOINTS_ENV))


#: /debug/profile sampling bounds: a handler thread blocks for the
#: whole window, so the knob-free query param is clamped hard
PROFILE_MAX_SECONDS = 30.0
PROFILE_MIN_SECONDS = 0.05
PROFILE_DEFAULT_HZ = 100.0

_DEBUG_INDEX = """\
live introspection endpoints (MXTPU_DEBUG_ENDPOINTS=1):
  GET /debug/stacks               all-thread stacks, trace-tagged JSON
  GET /debug/profile?seconds=S    on-demand sample window (S<=30;
      &hz=H&format=collapsed|chrome|json; &windows=1 serves the
      daemon sampler's rotated windows instead of sampling now)
  GET /debug/flight               live flight-recorder rings
  GET /debug/trace/<trace_id>     span-ring lookup for one trace
  GET /debug/vars                 every registered knob's live value
"""


def _query_params(query: str) -> dict:
    params = {}
    for part in query.split("&"):
        if "=" in part:
            k, _, v = part.partition("=")
            params[k] = v
    return params


def _json_body(obj) -> Tuple[str, bytes]:
    return ("application/json",
            json.dumps(obj, sort_keys=True, indent=1).encode())


def debug_route(path: str, query: str = ""
                ) -> Optional[Tuple[int, str, bytes]]:
    """The shared ``/debug/*`` dispatcher — one implementation serving
    both the serving :class:`~..serving.frontend.HttpFrontend`
    and this module's stdlib metrics endpoint (so trainers without a
    frontend get the same surface).  Returns ``(status, content_type,
    body)`` for debug paths, None for everything else (the caller falls
    through to its own routing).  Knob-gated: with
    ``MXTPU_DEBUG_ENDPOINTS`` unset every debug path 404s with an
    explanation — the surface is auth-free and must be an explicit
    opt-in."""
    if path != "/debug" and not path.startswith("/debug/"):
        return None
    if not debug_enabled():
        return (404, "text/plain; charset=utf-8",
                f"debug endpoints disabled (set {DEBUG_ENDPOINTS_ENV}=1"
                f" to enable)\n".encode())
    try:
        return _debug_route(path, _query_params(query))
    except Exception as e:   # noqa: BLE001 — introspection of a
        # possibly-wedged process: report the failure, never 500-loop
        # the whole handler away
        return (500, "text/plain; charset=utf-8",
                f"debug handler error: {type(e).__name__}: {e}\n"
                .encode())


def _debug_route(path: str, params: dict
                 ) -> Tuple[int, str, bytes]:
    from . import flight as _flight
    from . import sampler as _sampler
    from . import tracing as _tracing
    if path in ("/debug", "/debug/"):
        return (200, "text/plain; charset=utf-8",
                _DEBUG_INDEX.encode())
    if path == "/debug/stacks":
        ctype, body = _json_body({"ts": round(time.time(), 3),
                                  "pid": os.getpid(),
                                  "threads": _sampler.thread_stacks()})
        return (200, ctype, body)
    if path == "/debug/profile":
        fmt = params.get("format", "collapsed")
        if params.get("windows"):
            wins = _sampler.sampler().windows()
            if fmt == "json":
                ctype, body = _json_body(
                    {"windows": [w.to_dict() for w in wins]})
                return (200, ctype, body)
            text = _sampler.collapsed_from_windows(wins)
            return (200, "text/plain; charset=utf-8",
                    (text + "\n").encode())
        try:
            seconds = float(params.get("seconds", 1.0))
        except ValueError:
            seconds = 1.0
        seconds = min(max(seconds, PROFILE_MIN_SECONDS),
                      PROFILE_MAX_SECONDS)
        try:
            hz = float(params.get("hz", PROFILE_DEFAULT_HZ))
        except ValueError:
            hz = PROFILE_DEFAULT_HZ
        hz = min(max(hz, 1.0), 1000.0)
        win = _sampler.profile(seconds=seconds, hz=hz)
        if fmt == "chrome":
            ctype, body = _json_body(
                {"traceEvents":
                 _sampler.chrome_events_from_window(win),
                 "displayTimeUnit": "ms"})
            return (200, ctype, body)
        if fmt == "json":
            ctype, body = _json_body(win.to_dict())
            return (200, ctype, body)
        return (200, "text/plain; charset=utf-8",
                (win.collapsed() + "\n").encode())
    if path == "/debug/flight":
        ctype, body = _json_body(_flight.recorder().live())
        return (200, ctype, body)
    if path.startswith("/debug/trace/"):
        trace_id = path[len("/debug/trace/"):].strip("/")
        spans = _tracing.tracer().find(trace_id) if trace_id else []
        status = 200 if spans else 404
        ctype, body = _json_body({"trace_id": trace_id,
                                  "n_spans": len(spans),
                                  "spans": spans})
        return (status, ctype, body)
    if path == "/debug/vars":
        ctype, body = _json_body(list_env())
        return (200, ctype, body)
    return (404, "text/plain; charset=utf-8",
            b"unknown debug endpoint; GET /debug for the index\n")


class _Handler(BaseHTTPRequestHandler):
    server_version = "mxtpu-metrics"

    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler contract
        path, _, query = self.path.partition("?")
        status = 200
        dbg = debug_route(path, query)
        if dbg is not None:
            status, ctype, body = dbg
        elif path == "/metrics":
            # exemplar suffixes are legal only in OpenMetrics-shaped
            # output — a 0.0.4 scraper receiving them rejects the
            # ENTIRE scrape — so they are an explicit opt-in
            # (`/metrics?exemplars=1`), never the default exposition
            exemplars = "exemplars=1" in query.split("&")
            if aggregate_mode():
                text = prometheus_text_aggregate()
                exemplars = False   # the fleet view carries none
            else:
                text = prometheus_text(exemplars=exemplars)
            if exemplars:
                # exemplar suffixes are OpenMetrics syntax: label the
                # body so a parser that routes on Content-Type picks
                # the right grammar (EOF terminator required)
                text += "# EOF\n"
                ctype = ("application/openmetrics-text; "
                         "version=1.0.0; charset=utf-8")
            else:
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            body = text.encode()
        elif path == "/metrics.json":
            body = json.dumps(registry().snapshot(), sort_keys=True,
                              indent=1).encode()
            ctype = "application/json"
        else:
            self.send_error(404, "try /metrics, /metrics.json, /debug")
            return
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):   # no stderr chatter per scrape
        pass


class MetricsServer:
    """Serve the registry over HTTP on a daemon thread.

    ``port=0`` binds an ephemeral port (tests); the bound port is
    ``server.port``.  ``stop()`` shuts the listener down; the server also
    dies with the process (daemon thread) — scrape targets need no
    shutdown ceremony.
    """

    def __init__(self, port: int, addr: str = "0.0.0.0",
                 start: bool = True):
        self._httpd = ThreadingHTTPServer((addr, int(port)), _Handler)
        self._httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None
        if start:
            self.start()

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.5},
            daemon=True, name="mxtpu-metrics-server")
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
        self._thread = None


class JsonlWriter:
    """Append registry snapshots as JSON lines, with size-based rotation.

    Each line is ``{"ts": <unix seconds>, "metrics": {...snapshot...}}``.
    When the file would exceed ``max_bytes`` the current file rotates to
    ``<path>.1`` (one generation — the consumer is a log shipper, not an
    archive).  ``start()`` spawns a daemon thread writing every
    ``interval`` seconds; ``write_now()`` is the synchronous path (tests,
    end-of-run flushes).
    """

    def __init__(self, path: str, interval: float = 60.0,
                 max_bytes: int = 16 * 1024 * 1024):
        if not path:
            raise MXNetError("JsonlWriter needs a path")
        self.path = path
        self.interval = float(interval)
        self.max_bytes = int(max_bytes)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    def write_now(self) -> None:
        line = json.dumps({"ts": round(time.time(), 3),
                           "metrics": registry().snapshot()},
                          sort_keys=True) + "\n"
        with self._lock:
            try:
                if os.path.exists(self.path) and \
                        os.path.getsize(self.path) + len(line) > \
                        self.max_bytes:
                    os.replace(self.path, self.path + ".1")
            except OSError:
                pass                      # rotation is best-effort
            with open(self.path, "a") as f:
                f.write(line)

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def run():
            while not self._stop.wait(self.interval):
                try:
                    self.write_now()
                except OSError:
                    # disk-full/unlinked-dir must not kill the writer —
                    # the next tick retries; training never depends on it
                    pass

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="mxtpu-metrics-jsonl")
        self._thread.start()

    def stop(self, final_write: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if final_write:
            try:
                self.write_now()
            except OSError:
                pass


_env_server: Optional[MetricsServer] = None
_env_writer: Optional[JsonlWriter] = None
_env_lock = threading.Lock()


def maybe_start_from_env() -> None:
    """Start the HTTP endpoint and/or the JSONL writer if the opt-in env
    vars are set.  Idempotent; failures (port in use, unwritable path)
    warn instead of raising — observability must never take down the
    training job it observes."""
    global _env_server, _env_writer
    with _env_lock:
        port = get_env(METRICS_PORT_ENV).strip()
        jsonl = get_env(METRICS_JSONL_ENV).strip()
        if port or jsonl:
            # materialize the engine singleton so its metric families
            # exist from the first scrape/write, not from the first op
            from ..engine import engine
            engine()
        if port and _env_server is None:
            try:
                _env_server = MetricsServer(int(port))
            except (OSError, ValueError) as e:
                import warnings
                warnings.warn(
                    f"{METRICS_PORT_ENV}={port!r}: metrics endpoint not "
                    f"started ({e})", RuntimeWarning, stacklevel=2)
        if jsonl and _env_writer is None:
            try:
                interval = float(get_env(METRICS_INTERVAL_ENV))
                _env_writer = JsonlWriter(jsonl, interval=interval)
                _env_writer.start()
            except (OSError, ValueError) as e:
                import warnings
                warnings.warn(
                    f"{METRICS_JSONL_ENV}={jsonl!r}: JSONL metrics "
                    f"writer not started ({e})", RuntimeWarning,
                    stacklevel=2)


def env_server() -> Optional[MetricsServer]:
    """The endpoint ``maybe_start_from_env`` started, or None when it did
    not (no knob, or the bind failed and warned)."""
    return _env_server


def stop_from_env() -> None:
    """Stop and join what ``maybe_start_from_env`` started (the writer
    writes once more), so that the knobs can start it anew."""
    global _env_server, _env_writer
    with _env_lock:
        if _env_server is not None:
            _env_server.stop()
            _env_server = None
        if _env_writer is not None:
            _env_writer.stop()
            _env_writer = None
