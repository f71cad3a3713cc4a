"""``mx.profiler``: op events, spans and traces on one Chrome timeline,
and the card's kernels when ``profile_all=True``.

Counterpart of ``mxnet_tpu/profiler.py`` (MXNet's ``python/mxnet/
profiler.py``).  Two levels, as the JAX package has them:

- **Op events** from the engine's dispatch listener: every op of the
  ``nd`` registry becomes a duration event in a Chrome trace (``dump()``)
  and a row of an aggregate table (``dumps()``).  The duration is the
  host's dispatch time: CUDA runs the op's kernels after the call
  returns, so an op's device time lives in the device trace below (the
  JAX package has the same split, XLA dispatch being asynchronous too).
  ``trace.span`` exits (the serving and loader spans) and the causal
  tracer's span ring join the same timeline.
- **The device trace** when ``profile_all=True``: ``torch.profiler``
  (CUPTI's CUDA activity, the CPU ops beside it) runs from ``start`` to
  ``stop`` and is written as a Chrome trace into ``trace_dir`` if
  configured, else ``<filename>_cuda/`` (the JAX package writes its XLA
  trace to ``<filename>_xla/``).  ``dump()`` after the stop merges its
  events into the profile, shifted onto the profiler's clock by a marker
  range opened at ``start``, each of its processes on a lane of its own
  (``pid`` from :data:`Profiler.DEVICE_PID_BASE`).  A kernel replayed
  from a CUDA graph may show only as the ``cudaGraphLaunch`` that
  replayed it.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional

from .base import MXNetError
from .engine import engine

__all__ = ["set_config", "set_state", "state", "pause", "resume", "dump",
           "dumps", "Profiler"]

#: the range opened at ``start`` in the device trace: its timestamp there
#: is the profiler's clock at ``start``, which aligns the two timelines
_MARKER = "mx.profiler.start"


class Profiler:
    _inst: Optional["Profiler"] = None

    #: the device trace's processes render from this pid up, past any
    #: host index
    DEVICE_PID_BASE = 1000
    #: tracing events render on their own tid lanes, offset past the
    #: profiler's per-thread lanes so the two namespaces never collide
    _TRACE_TID_BASE = 64

    def __init__(self):
        self.filename = "profile_output.json"
        self.profile_all = False
        self.aggregate_stats = True
        self.trace_dir: Optional[str] = None
        self._running = False
        self._paused = False
        self._events: List[dict] = []
        self._agg: Dict[str, List[float]] = {}
        self._lock = threading.Lock()
        self._listener_installed = False
        self._t0 = time.perf_counter()
        # one timeline: pid = this process's host index (resolved at
        # start), tid = a small per-thread lane
        self._pid: Optional[int] = None
        self._tids: Dict[int, int] = {}      # thread ident -> lane
        self._tnames: Dict[int, str] = {}    # lane -> thread name
        self._torch_prof = None
        self._marker = None
        self._marker_ts = 0.0                # our clock at start, in µs
        self.marker_err_us = 0.0
        self.device_trace: Optional[str] = None   # last device trace file

    def _host_pid(self) -> int:
        # cached so the per-event path never probes; start() clears it
        if self._pid is None:
            from .observability.registry import host_id
            self._pid = host_id()
        return self._pid

    def _lane_locked(self) -> int:
        """Small stable per-thread tid; callers hold self._lock."""
        ident = threading.get_ident()
        lane = self._tids.get(ident)
        if lane is None:
            lane = len(self._tids)
            self._tids[ident] = lane
            self._tnames[lane] = threading.current_thread().name
        return lane

    @classmethod
    def get(cls) -> "Profiler":
        if cls._inst is None:
            cls._inst = Profiler()
        return cls._inst

    # -- engine listener ---------------------------------------------------
    def _on_op(self, op_name: str, outputs, dispatch_us: float = 0.0) -> None:
        if not self._running or self._paused:
            return
        if op_name.startswith("span:"):
            # the engine-listener echo of a trace span: the real event
            # arrives through _on_span
            return
        now = (time.perf_counter() - self._t0) * 1e6   # µs
        dur = max(dispatch_us, 0.1)
        pid = self._host_pid()
        with self._lock:
            self._events.append({
                "name": op_name, "ph": "X", "pid": pid,
                "tid": self._lane_locked(), "ts": now - dur, "dur": dur,
                "cat": "operator"})
            self._agg.setdefault(op_name, []).append(dur)

    # -- span listener (trace.span -> the timeline) ------------------------
    def _on_span(self, name: str, t_end: float, dur_us: float,
                 args: Optional[dict] = None) -> None:
        """``trace.span`` exits land here as duration events on the
        thread's lane, their ``args`` (step number, batch id) as the
        event's ``args``."""
        if not self._running or self._paused:
            return
        ts_end = (t_end - self._t0) * 1e6              # µs
        dur = max(dur_us, 0.1)
        pid = self._host_pid()
        ev = {"name": name, "ph": "X", "pid": pid, "ts": ts_end - dur,
              "dur": dur, "cat": "span"}
        if args:
            ev["args"] = dict(args)
        with self._lock:
            ev["tid"] = self._lane_locked()
            self._events.append(ev)
            self._agg.setdefault(f"span:{name}", []).append(dur)

    # -- the device trace --------------------------------------------------
    def _start_device_trace(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, \
            record_function
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._torch_prof = profile(activities=acts)
        self._torch_prof.__enter__()
        with record_function(_MARKER + ".warmup"):
            pass                  # the first range pays a lazy setup
        t_before = time.perf_counter()
        self._marker = record_function(_MARKER)
        self._marker.__enter__()
        t_after = time.perf_counter()
        self._marker_ts = ((t_before + t_after) / 2 - self._t0) * 1e6
        # the alignment's uncertainty: the marker's own timestamp lies
        # somewhere in [t_before, t_after]
        self.marker_err_us = (t_after - t_before) / 2 * 1e6

    def _stop_device_trace(self) -> None:
        prof, self._torch_prof = self._torch_prof, None
        if prof is None:
            return
        import torch
        if self._marker is not None:
            self._marker.__exit__(None, None, None)
            self._marker = None
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        os.makedirs(self.trace_dir, exist_ok=True)
        path = os.path.join(self.trace_dir,
                            f"cuda_trace_{os.getpid()}.json")
        prof.export_chrome_trace(path)
        self.device_trace = path

    def device_events(self) -> List[dict]:
        """The last device trace's events on the profiler's clock, each
        of its processes renumbered from :data:`DEVICE_PID_BASE` (empty
        before the first ``profile_all`` stop)."""
        if not self.device_trace or not os.path.exists(self.device_trace):
            return []
        with open(self.device_trace) as f:
            raw = json.load(f)
        events = raw.get("traceEvents", raw) if isinstance(raw, dict) \
            else raw
        marker = next((e for e in events if e.get("name") == _MARKER
                       and e.get("cat") == "user_annotation"), None)
        shift = 0.0 if marker is None \
            else self._marker_ts - float(marker["ts"])
        pids: Dict[object, int] = {}
        out = []
        for e in events:
            e = dict(e)
            if "pid" in e:
                e["pid"] = pids.setdefault(e["pid"],
                                           self.DEVICE_PID_BASE + len(pids))
            if "ts" in e:
                e["ts"] = float(e["ts"]) + shift
            if e.get("ph") == "M" and e.get("name") == "process_name":
                e.setdefault("args", {})
                e["args"]["name"] = f"torch.profiler: " \
                    f"{e['args'].get('name', '')}"
            out.append(e)
        return out

    def start(self) -> None:
        self._pid = None               # re-resolve the host index per run
        self._host_pid()
        if not self._listener_installed:
            engine().add_listener(self._on_op)
            from .observability.trace import add_span_listener
            add_span_listener(self._on_span)
            self._listener_installed = True
        self._running = True
        if self.profile_all and not self.trace_dir:
            # profile_all without an explicit trace_dir: the device trace
            # goes next to the chrome-trace file
            self.trace_dir = self.filename + "_cuda"
        if self.profile_all and self._torch_prof is None:
            self._start_device_trace()

    def stop(self) -> None:
        self._stop_device_trace()
        self._running = False
        # drop the engine tap: a stopped profiler must cost nothing
        # (start() re-installs)
        if self._listener_installed:
            engine().remove_listener(self._on_op)
            from .observability.trace import remove_span_listener
            remove_span_listener(self._on_span)
            self._listener_installed = False

    # -- output ------------------------------------------------------------
    def dump(self, finished: bool = True) -> None:
        """Write the Chrome trace to ``filename``: the op and span events,
        the tracer's span ring with its flow arrows, and the last device
        trace."""
        pid = self._host_pid()
        with self._lock:
            meta = [{"name": "process_name", "ph": "M", "pid": pid,
                     "args": {"name": f"host {pid}"}}]
            for lane, tname in sorted(self._tnames.items()):
                meta.append({"name": "thread_name", "ph": "M",
                             "pid": pid, "tid": lane,
                             "args": {"name": tname}})
            events = list(self._events)
        # the causal tracer's span ring joins on the same perf_counter
        # clock, with its parent -> child and link arrows
        try:
            from .observability import tracing as _tracing
            trc = _tracing.tracer()
            tev = trc.chrome_events(base_pc=self._t0,
                                    tid_offset=self._TRACE_TID_BASE)
            if tev:
                for lane, tname in sorted(trc.lane_names().items()):
                    meta.append({"name": "thread_name", "ph": "M",
                                 "pid": pid,
                                 "tid": self._TRACE_TID_BASE + lane,
                                 "args": {"name": f"trace:{tname}"}})
                events += tev
        except Exception:   # noqa: BLE001 — a broken tracer must not
            pass            # break the profile dump
        events += self.device_events()
        payload = {"traceEvents": meta + events,
                   "displayTimeUnit": "ms"}
        with open(self.filename, "w") as f:
            json.dump(payload, f)

    def dumps(self, reset: bool = False) -> str:
        with self._lock:
            rows = []
            for name, durs in sorted(self._agg.items()):
                total = sum(durs)
                rows.append((name, len(durs), total, total / len(durs),
                             min(durs), max(durs)))
            if reset:
                self._agg.clear()
        head = (f"{'Name':<32}{'Calls':>8}{'Total(us)':>14}"
                f"{'Avg(us)':>12}{'Min(us)':>12}{'Max(us)':>12}\n")
        lines = [head, "-" * len(head) + "\n"]
        for name, calls, total, avg, mn, mx in rows:
            lines.append(f"{name:<32}{calls:>8}{total:>14.1f}"
                         f"{avg:>12.1f}{mn:>12.1f}{mx:>12.1f}\n")
        # the engine's counters ride along (the port has no bulked
        # dispatch, so its footer is the waits and host reads)
        s = engine().stats()
        lines.append("\nengine dispatch stats:\n")
        for k in ("engine_type", "waits", "host_reads"):
            lines.append(f"  {k:<24}{s[k]}\n")
        return "".join(lines)

    def reset(self) -> None:
        with self._lock:
            self._events.clear()
            self._agg.clear()


def set_config(**kwargs) -> None:
    """reference: mx.profiler.set_config(profile_all=..., filename=...)"""
    p = Profiler.get()
    if "filename" in kwargs:
        p.filename = kwargs.pop("filename")
    if "profile_all" in kwargs:
        p.profile_all = bool(kwargs.pop("profile_all"))
    if "aggregate_stats" in kwargs:
        p.aggregate_stats = bool(kwargs.pop("aggregate_stats"))
    if "trace_dir" in kwargs:
        p.trace_dir = kwargs.pop("trace_dir")
    # accepted and ignored, as the JAX package does: one dispatch funnel
    # means one event stream
    kwargs.pop("profile_symbolic", None)
    kwargs.pop("profile_imperative", None)
    kwargs.pop("profile_memory", None)
    kwargs.pop("profile_api", None)
    if kwargs:
        raise MXNetError(f"unknown profiler config keys {sorted(kwargs)}")


def set_state(state_: str = "stop") -> None:
    """'run' or 'stop' (reference: mx.profiler.set_state)."""
    p = Profiler.get()
    if state_ == "run":
        p.start()
    elif state_ == "stop":
        p.stop()
    else:
        raise MXNetError("state must be 'run' or 'stop'")


def state() -> str:
    return "run" if Profiler.get()._running else "stop"


def pause() -> None:
    Profiler.get()._paused = True


def resume() -> None:
    Profiler.get()._paused = False


def dump(finished: bool = True) -> None:
    Profiler.get().dump(finished)


def dumps(reset: bool = False) -> str:
    return Profiler.get().dumps(reset)
