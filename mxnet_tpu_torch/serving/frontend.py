"""HTTP frontend: the wire protocol over the model registry.

Counterpart of ``mxnet_tpu/serving/frontend.py`` on the standard
library's ``http.server``: N named models behind one port, JSON for
one-shot inference and Server-Sent Events for token streaming::

    GET  /healthz                      liveness (the process is up)
    GET  /readyz                       readiness (models loaded and warm,
                                       not draining); 503 otherwise
    GET  /v1/models                    registry listing and live stats
    POST /v1/models/<name>/predict     {"inputs": [[...], ...]} ->
                                       {"outputs": [...]} over
                                       submit()/result()
    POST /v1/models/<name>/generate    {"prompt": [ids]} -> SSE stream,
                                       one ``data:`` event a token,
                                       ended by ``event: done``

Contracts:

- **parity**: a predict response carries exactly the floats ``submit()``
  returns (JSON round-trips them at repr precision);
- **streaming**: tokens flush per decode iteration (TCP_NODELAY, one
  ``flush()`` an event); a client that hangs up mid-stream cancels its
  generation at the next iteration edge and its KV blocks return to the
  pool;
- **admission**: the registry's priority gate runs before the model's
  own admission queue; both reject as HTTP 429 with a JSON body naming
  the reason;
- **trace stitching**: a W3C ``traceparent`` request header becomes the
  parent of the request's ``serving.request``/``serving.generate`` root
  (one trace from the caller's socket to the dispatch span); the response
  echoes the root's ``traceparent`` (with ``MXTPU_TRACE`` on and the
  request sampled);
- **introspection**: ``GET /debug/*`` (stacks, an on-demand profile, the
  flight rings, a trace by id, the knobs) is the shared
  ``observability.export.debug_route``, behind ``MXTPU_DEBUG_ENDPOINTS``
  (without it every ``/debug`` path answers 404);
- **graceful shutdown**: ``stop()`` (or SIGTERM via
  :meth:`HttpFrontend.install_sigterm`, which also installs the
  ``MXTPU_STACKS_SIGNAL`` stack dump) closes the listener, then drains
  every registered server.

Knobs: ``MXTPU_FRONTEND_PORT``, ``MXTPU_FRONTEND_PRIORITY``,
``MXTPU_FRONTEND_SLO_MS``, ``MXTPU_DEBUG_ENDPOINTS``.
"""
from __future__ import annotations

import json
import signal
import socket as _socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from ..base import get_env
from ..observability import tracing as _tracing
from ..observability.export import debug_route as _debug_route
from ..observability.watchdog import install_stack_signal, \
    uninstall_stack_signal
from .batcher import (DeadlineExceeded, RequestCancelled, ServerClosed,
                      ServerOverloaded, ServingError)
from .buckets import NoBucketError
from .registry import ModelRegistry, UnknownModel
from .server import _install_sigterm

__all__ = ["HttpFrontend", "FRONTEND_PORT_ENV"]

FRONTEND_PORT_ENV = "MXTPU_FRONTEND_PORT"

#: HTTP status for each serving-error shape (the wire contract)
_STATUS = (
    (UnknownModel, 404),
    (ServerOverloaded, 429),
    (DeadlineExceeded, 504),
    (RequestCancelled, 499),      # nginx's "client closed request"
    (ServerClosed, 503),
    (NoBucketError, 400),
)


def _status_for(exc: BaseException) -> int:
    for etype, code in _STATUS:
        if isinstance(exc, etype):
            return code
    if isinstance(exc, TimeoutError):
        return 504
    return 400 if isinstance(exc, (ValueError, KeyError, TypeError)) \
        else 500


class _Handler(BaseHTTPRequestHandler):
    server_version = "mxtpu-frontend"
    #: HTTP/1.1: keep-alive for the JSON endpoints (Content-Length
    #: delimited); SSE responses opt out per response with
    #: ``Connection: close`` (a close-delimited stream)
    protocol_version = "HTTP/1.1"

    @property
    def _fe(self) -> "HttpFrontend":
        return self.server.frontend

    def log_message(self, fmt, *args):   # no stderr line per request
        pass

    def _read_json(self) -> dict:
        n = int(self.headers.get("Content-Length") or 0)
        if n <= 0:
            return {}
        payload = json.loads(self.rfile.read(n))
        if not isinstance(payload, dict):
            raise ValueError("request body must be a JSON object")
        return payload

    def _drain_body(self) -> None:
        """Discard the unread request body without parsing it, so a
        rejection issued before ingestion (shed 429, unknown model) stays
        cheap while the keep-alive stream keeps its framing."""
        n = int(self.headers.get("Content-Length") or 0)
        while n > 0:
            chunk = self.rfile.read(min(n, 1 << 16))
            if not chunk:
                break
            n -= len(chunk)

    def _send_json(self, code: int, obj: dict,
                   extra_headers=()) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in extra_headers:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _send_error_json(self, exc: BaseException) -> None:
        code = _status_for(exc)
        self._send_json(code, {"error": type(exc).__name__,
                               "detail": str(exc), "status": code})

    def _remote_ctx(self):
        """The caller's W3C trace context, if the header carries one."""
        return _tracing.parse_traceparent(
            self.headers.get("traceparent"))

    # -- GET -----------------------------------------------------------
    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler contract
        path, _, query = self.path.partition("?")
        dbg = _debug_route(path, query)
        if dbg is not None:
            # the shared /debug/* surface, knob-gated and pre-encoded
            status, ctype, body = dbg
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif path == "/healthz":
            self._send_json(200, {"ok": True})
        elif path == "/readyz":
            fe = self._fe
            if fe.draining:
                self._send_json(503, {"ready": False,
                                      "reason": "draining"})
            elif not fe.registry.ready():
                self._send_json(503, {"ready": False,
                                      "reason": "models not ready"})
            else:
                self._send_json(200, {"ready": True})
        elif path == "/v1/models":
            self._send_json(200, self._fe.registry.describe())
        else:
            self._send_json(404, {"error": "NotFound", "status": 404,
                                  "detail": "try /v1/models, /healthz, "
                                            "/readyz, /debug"})

    # -- POST ----------------------------------------------------------
    def do_POST(self):  # noqa: N802 — BaseHTTPRequestHandler contract
        parts = [p for p in self.path.partition("?")[0].split("/") if p]
        if not (len(parts) == 4 and parts[:2] == ["v1", "models"]
                and parts[3] in ("predict", "generate")):
            self._drain_body()
            self._send_json(404, {"error": "NotFound", "status": 404,
                                  "detail": "POST /v1/models/<name>/"
                                            "predict|generate"})
            return
        name, verb = parts[2], parts[3]
        try:
            # admission before ingestion: a shed (429) or an unknown model
            # does not pay the JSON parse
            try:
                entry = self._fe.registry.get(name)
                self._fe.registry.admit(entry)
            except ServingError:
                self._drain_body()
                raise
            payload = self._read_json()
            if entry.kind != verb:
                raise ValueError(
                    f"model {name!r} is a {entry.kind} model — POST "
                    f".../{entry.kind}")
            if verb == "predict":
                self._predict(entry, payload)
            else:
                self._generate(entry, payload)
        except (BrokenPipeError, ConnectionResetError):
            return                # the client is gone; nothing to answer
        except Exception as e:    # noqa: BLE001 — the wire boundary:
            self._send_error_json(e)   # every failure is a status

    # -- predict -------------------------------------------------------
    def _predict(self, entry, payload: dict) -> None:
        t0 = time.monotonic()
        raw = payload["inputs"] if "inputs" in payload \
            else [payload["input"]]
        dtypes = payload.get("dtypes")
        arrays = []
        for i, v in enumerate(raw):
            dt = dtypes[i] if dtypes else payload.get("dtype")
            arrays.append(np.asarray(v, dtype=dt) if dt else np.asarray(v))
        entry.c_requests.inc()
        # the caller's context (when given) parents the request root the
        # server opens at submit
        with _tracing.activate(self._remote_ctx()):
            req = entry.server.submit(
                *arrays, deadline_ms=payload.get("deadline_ms"))
        result = req.result(timeout=float(payload.get("timeout_s", 60.0)))
        rows = result if isinstance(result, tuple) else (result,)
        dur_us = (time.monotonic() - t0) * 1e6
        trace_id = None if req.trace is None else req.trace.trace_id
        entry.h_request.observe(dur_us, trace_id=trace_id)
        entry.c_done.inc()
        headers = []
        if req.trace is not None:
            headers.append(("traceparent", req.trace.traceparent))
        self._send_json(200, {"model": entry.name, "rid": req.rid,
                              "outputs": [r.tolist() for r in rows],
                              "shapes": [list(r.shape) for r in rows],
                              "us": round(dur_us, 1)},
                        extra_headers=headers)

    # -- generate (SSE) ------------------------------------------------
    def _generate(self, entry, payload: dict) -> None:
        t0 = time.monotonic()
        kw = {}
        if payload.get("max_new_tokens") is not None:
            kw["max_new_tokens"] = int(payload["max_new_tokens"])
        if payload.get("deadline_ms") is not None:
            kw["deadline_ms"] = float(payload["deadline_ms"])
        if payload.get("eos") is not None:
            kw["eos"] = int(payload["eos"])
        entry.c_requests.inc()
        with _tracing.activate(self._remote_ctx()):
            req = entry.server.submit_generate(payload["prompt"], **kw)
        # SSE: a close-delimited stream (no Content-Length), flushed per
        # token; TCP_NODELAY so each event leaves the host at once
        try:
            self.connection.setsockopt(_socket.IPPROTO_TCP,
                                       _socket.TCP_NODELAY, 1)
        except OSError:
            pass
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Connection", "close")
        if req.trace is not None:
            self.send_header("traceparent", req.trace.traceparent)
        self.close_connection = True
        self.end_headers()
        timeout = float(payload.get("timeout_s", 60.0))
        n = 0
        try:
            for tok in req.stream(timeout=timeout):
                if n == 0:
                    trace_id = None if req.trace is None \
                        else req.trace.trace_id
                    entry.h_ttft.observe((time.monotonic() - t0) * 1e6,
                                         trace_id=trace_id)
                self._write_event(
                    f'data: {{"token": {int(tok)}, "index": {n}}}\n\n')
                n += 1
        except OSError:
            # the client hung up mid-stream: cancel, so the scheduler
            # retires the slot and the KV blocks return to the pool
            entry.server.cancel(req)
            return
        except ServingError as e:
            # the stream already started: the error rides the stream
            try:
                self._write_event(
                    "event: error\ndata: "
                    + json.dumps({"error": type(e).__name__,
                                  "detail": str(e),
                                  "status": _status_for(e)}) + "\n\n")
            except OSError:
                pass
            return
        dur_us = (time.monotonic() - t0) * 1e6
        trace_id = None if req.trace is None else req.trace.trace_id
        entry.h_request.observe(dur_us, trace_id=trace_id)
        entry.c_done.inc()
        self._write_event(
            "event: done\ndata: "
            + json.dumps({"model": entry.name, "rid": req.rid,
                          "tokens": req.tokens, "n": n,
                          "us": round(dur_us, 1)}) + "\n\n")

    def _write_event(self, event: str) -> None:
        """One SSE event onto the wire: encode, write, flush (TCP_NODELAY
        is set at stream start, so the flush is the send)."""
        self.wfile.write(event.encode())
        self.wfile.flush()


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True
    #: the listen backlog: ``socketserver``'s default of 5 resets the
    #: connections of a burst of clients (69 of 96 connecting at once)
    request_queue_size = 128


class HttpFrontend:
    """The front door: one listener over a
    :class:`~mxnet_tpu_torch.serving.registry.ModelRegistry`.

    ``port=0`` binds an ephemeral port (the bound one is ``frontend.port``).
    ``stop(drain=True)`` closes the listener, then drains every registered
    server; :meth:`install_sigterm` wires that to SIGTERM, the handler
    never blocking in signal context."""

    def __init__(self, registry: Optional[ModelRegistry] = None,
                 port: Optional[int] = None, addr: str = "0.0.0.0",
                 start: bool = False):
        if port is None:
            knob = str(get_env(FRONTEND_PORT_ENV)).strip()
            port = int(knob) if knob else 0
        self.registry = registry if registry is not None \
            else ModelRegistry()
        self._httpd = _Server((addr, int(port)), _Handler)
        self._httpd.frontend = self
        self._thread: Optional[threading.Thread] = None
        self._prev_sigterm = None
        self._stack_signal = False
        self.draining = False
        if start:
            self.start()

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    # -- lifecycle -----------------------------------------------------
    def start(self) -> "HttpFrontend":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.25},
            daemon=True, name="mxtpu-frontend")
        self._thread.start()
        return self

    def stop(self, drain: bool = True,
             timeout: Optional[float] = None) -> None:
        """Graceful shutdown: stop accepting, then drain (or shed) every
        registered server.  Handler threads holding request futures
        complete on the servers' own drain path."""
        self.draining = True
        if self._thread is not None:
            self._httpd.shutdown()
            self._thread.join(timeout=5)
            self._thread = None
        self._httpd.server_close()
        self.registry.stop_all(drain=drain, timeout=timeout)

    def __enter__(self) -> "HttpFrontend":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.stop(drain=exc_type is None)

    def install_sigterm(self) -> None:
        """Chain a SIGTERM handler that stops the frontend gracefully
        (listener down, every model drained), then calls the previous
        handler; the drain runs on a non-daemon thread of its own.  The
        ``MXTPU_STACKS_SIGNAL`` stack dump rides along: a wedged drain is
        when an operator wants ``kill -QUIT``.  From the main thread."""
        self._stack_signal = install_stack_signal()
        self._prev_sigterm = _install_sigterm(self, "mxtpu-frontend")

    def uninstall_sigterm(self) -> None:
        """Put back the SIGTERM handler (and the stack signal's) that
        :meth:`install_sigterm` replaced."""
        if self._prev_sigterm is not None:
            signal.signal(signal.SIGTERM, self._prev_sigterm)
            self._prev_sigterm = None
        if self._stack_signal:
            uninstall_stack_signal()
            self._stack_signal = False
