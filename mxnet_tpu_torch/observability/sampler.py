"""Continuous stack-sampling profiler: what every thread is doing, now.

Counterpart of ``mxnet_tpu/observability/sampler.py``.  The other layers
record after the fact (the metrics aggregate, traces record completed
spans, the flight recorder dumps at death); this one answers "what is
this process executing right now?": walk ``sys._current_frames()`` at N
Hz, fold each thread's frames into a collapsed stack string, and count
occurrences (the flamegraph input format).  The walk runs on the
sampler's thread; the sampled threads pay only its share of the GIL.

Three consumers:

- the **daemon sampler** (``MXTPU_PROF_SAMPLE_HZ`` > 0): samples
  continuously into rotating :class:`ProfileWindow` buckets
  (``MXTPU_PROF_WINDOW_SECS`` a window, ``MXTPU_PROF_WINDOWS`` kept),
  served by ``/debug/profile?windows=1`` and shipped in watchdog
  postmortems;
- **on-demand windows** (:func:`profile`): sample for S seconds on the
  caller's thread (the ``/debug/profile?seconds=S`` handler);
- **point-in-time dumps** (:func:`thread_stacks`): one walk of every
  thread (``/debug/stacks``, the ``MXTPU_STACKS_SIGNAL`` handler,
  watchdog postmortems).

While any consumer is active the tracing layer mirrors span activations
into a cross-thread map (:func:`.tracing.thread_spans`), so each sample
and stack dump carries the owning thread's active ``trace_id``: a
``ModelServer`` dispatch worker's frames are tagged with the request
whose batch it is running.  The fold key is function identity
(``file:function``), at most ``MAX_DEPTH`` frames.  A CUDA kernel runs
on the card, not in a thread's frames: a worker waiting for one shows
as the frame that waits (the readback's stream synchronise).
"""
from __future__ import annotations

import os
import sys
import threading
from collections import deque
from time import perf_counter, sleep, time as _wall
from typing import Deque, Dict, List, Optional, Tuple

from ..base import get_env
from .registry import registry

__all__ = ["ProfileWindow", "StackSampler", "sampler", "profile",
           "thread_stacks", "collapsed_from_windows",
           "chrome_events_from_window", "maybe_start_from_env",
           "SAMPLE_HZ_ENV", "WINDOW_SECS_ENV", "WINDOWS_ENV"]

SAMPLE_HZ_ENV = "MXTPU_PROF_SAMPLE_HZ"
WINDOW_SECS_ENV = "MXTPU_PROF_WINDOW_SECS"
WINDOWS_ENV = "MXTPU_PROF_WINDOWS"

#: frames kept per sampled stack (outermost frames beyond this drop)
MAX_DEPTH = 64

# memoized raw-environ probe for the off path (the tracing idiom: one
# dict hit per maybe_start_from_env call while the knob is unchanged)
_ENV_DATA = getattr(os.environ, "_data", None) if os.name == "posix" \
    else None
if not isinstance(_ENV_DATA, dict):
    _ENV_DATA = None
_HZ_KEY_B = SAMPLE_HZ_ENV.encode()


def _raw_env(key_bytes: bytes, key_str: str):
    """Raw environ entry for a DECLARED knob (compared against a memo;
    parsing goes through get_env only when the raw entry changed)."""
    if _ENV_DATA is not None:
        return _ENV_DATA.get(key_bytes)
    return os.environ.get(key_str)


def _frame_key(code) -> str:
    """Fold key for one frame: function identity, not the live line —
    line numbers move every sample and would shatter the fold."""
    return f"{os.path.basename(code.co_filename)}:{code.co_name}"


def _fold(frame, prefix: str) -> str:
    """Collapse a live frame chain into ``prefix;outer;...;leaf``."""
    parts: List[str] = []
    f = frame
    while f is not None and len(parts) < MAX_DEPTH:
        parts.append(_frame_key(f.f_code))
        f = f.f_back
    parts.append(prefix)
    parts.reverse()
    return ";".join(parts)


def _span_tags() -> Dict[int, Tuple[str, str]]:
    """ident → (trace_id, span name) for threads with an active span
    (empty unless thread-span tracking is enabled)."""
    from . import tracing as _tracing
    tags: Dict[int, Tuple[str, str]] = {}
    for ident, sp in _tracing.thread_spans().items():
        tid = getattr(sp, "trace_id", None)
        if tid:
            tags[ident] = (tid, getattr(sp, "name", "") or "")
    return tags


def thread_stacks() -> List[dict]:
    """Every thread's current stack, flight-style JSON: one record per
    thread with name/daemon/ident, outermost-first frames (with LIVE
    line numbers — this is a point-in-time dump, not a fold), and the
    active trace span when tracking is on."""
    frames = sys._current_frames()
    by_ident = {t.ident: t for t in threading.enumerate()}
    tags = _span_tags()
    me = threading.get_ident()
    out: List[dict] = []
    for ident, frame in frames.items():
        t = by_ident.get(ident)
        stack: List[dict] = []
        f = frame
        while f is not None and len(stack) < MAX_DEPTH:
            code = f.f_code
            stack.append({"file": code.co_filename,
                          "func": code.co_name,
                          "line": f.f_lineno})
            f = f.f_back
        stack.reverse()
        rec = {"ident": ident,
               "name": t.name if t is not None else f"thread-{ident}",
               "daemon": bool(t.daemon) if t is not None else None,
               "current": ident == me,
               "frames": stack}
        tag = tags.get(ident)
        if tag is not None:
            rec["trace_id"], rec["span"] = tag
        out.append(rec)
    out.sort(key=lambda r: r["name"])
    return out


class ProfileWindow:
    """One bounded bucket of folded samples: ``counts`` maps
    ``(collapsed_stack, trace_id)`` → occurrences.  The trace_id key
    component keeps per-trace attribution without a second structure;
    :meth:`collapsed` aggregates it away for the flamegraph view."""

    __slots__ = ("t0", "t1", "hz", "samples", "counts", "_t0_pc")

    def __init__(self, hz: float):
        self.t0 = _wall()
        self.t1: Optional[float] = None
        self.hz = float(hz)
        self.samples = 0
        self.counts: Dict[Tuple[str, str], int] = {}
        self._t0_pc = perf_counter()

    @property
    def age_s(self) -> float:
        return perf_counter() - self._t0_pc

    def add(self, stack: str, trace_id: str = "") -> None:
        key = (stack, trace_id)
        self.counts[key] = self.counts.get(key, 0) + 1

    def close(self) -> None:
        if self.t1 is None:
            self.t1 = _wall()

    def collapsed(self) -> str:
        """The window as collapsed-stack text (``stack count`` lines,
        flamegraph.pl / speedscope input), trace tags aggregated away."""
        agg: Dict[str, int] = {}
        for (stack, _tid), n in self.counts.items():
            agg[stack] = agg.get(stack, 0) + n
        return "\n".join(f"{s} {n}" for s, n in
                         sorted(agg.items(), key=lambda kv: -kv[1]))

    def by_trace(self) -> Dict[str, int]:
        """trace_id → sample count (untagged samples under ``""``)."""
        agg: Dict[str, int] = {}
        for (_stack, tid), n in self.counts.items():
            agg[tid] = agg.get(tid, 0) + n
        return agg

    def to_dict(self) -> dict:
        return {"t0": round(self.t0, 3),
                "t1": round(self.t1, 3) if self.t1 is not None else None,
                "hz": self.hz,
                "samples": self.samples,
                "stacks": [{"stack": s, "trace_id": tid, "count": n}
                           for (s, tid), n in
                           sorted(self.counts.items(),
                                  key=lambda kv: -kv[1])]}


def collapsed_from_windows(windows: List[ProfileWindow]) -> str:
    """Merged collapsed-stack text across windows (the
    ``/debug/profile`` all-windows view)."""
    agg: Dict[str, int] = {}
    for w in windows:
        for (stack, _tid), n in w.counts.items():
            agg[stack] = agg.get(stack, 0) + n
    return "\n".join(f"{s} {n}" for s, n in
                     sorted(agg.items(), key=lambda kv: -kv[1]))


def chrome_events_from_window(win: ProfileWindow) -> List[dict]:
    """The window as chrome-trace ``X`` events: per thread lane, each
    folded stack becomes one block whose duration is its sample-count
    share of the window (``count / hz``) — a poor man's flamechart that
    opens directly in Perfetto.  Event args carry the full collapsed
    stack and the trace tag."""
    period_us = 1e6 / max(win.hz, 1e-6)
    lanes: Dict[str, int] = {}
    cursors: Dict[str, float] = {}
    events: List[dict] = []
    base = win.t0 * 1e6
    for (stack, tid), n in sorted(win.counts.items(),
                                  key=lambda kv: -kv[1]):
        thread = stack.split(";", 1)[0]
        lane = lanes.setdefault(thread, len(lanes))
        ts = cursors.get(thread, 0.0)
        dur = n * period_us
        cursors[thread] = ts + dur
        leaf = stack.rsplit(";", 1)[-1]
        args = {"stack": stack, "count": n}
        if tid:
            args["trace_id"] = tid
        events.append({"name": leaf, "ph": "X", "cat": "sample",
                       "pid": 0, "tid": lane, "ts": base + ts,
                       "dur": dur, "args": args})
    events.extend({"name": "thread_name", "ph": "M", "pid": 0,
                   "tid": lane, "args": {"name": thread}}
                  for thread, lane in lanes.items())
    return events


def _collect_into(win: ProfileWindow, skip_ident: int) -> int:
    """One sampling pass: walk every thread's frames (except
    ``skip_ident`` — the sampler itself), fold, count.  Returns the
    number of stacks folded."""
    tags = _span_tags()
    names = {t.ident: t.name for t in threading.enumerate()}
    folded = 0
    for ident, frame in sys._current_frames().items():
        if ident == skip_ident:
            continue
        name = names.get(ident) or f"thread-{ident}"
        tag = tags.get(ident)
        win.add(_fold(frame, name), tag[0] if tag is not None else "")
        folded += 1
    win.samples += 1
    return folded


class StackSampler:
    """The daemon sampler: a background thread folding all-thread
    stacks into the current :class:`ProfileWindow` at :attr:`hz`,
    rotating windows into a bounded ring.  ``start()``/``stop()`` are
    idempotent; the rate is live (``set_rate`` applies next tick)."""

    def __init__(self, hz: Optional[float] = None,
                 window_secs: Optional[float] = None,
                 windows: Optional[int] = None):
        self.hz = float(get_env(SAMPLE_HZ_ENV) if hz is None else hz)
        self.window_secs = float(get_env(WINDOW_SECS_ENV)
                                 if window_secs is None else window_secs)
        cap = int(get_env(WINDOWS_ENV) if windows is None else windows)
        self._windows: Deque[ProfileWindow] = deque(maxlen=max(1, cap))
        self._cur: Optional[ProfileWindow] = None
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        reg = registry()
        self._c_samples = reg.counter(
            "profiler.samples",
            help="sampling passes taken by the stack sampler")
        self._c_rotations = reg.counter(
            "profiler.windows_rotated",
            help="profile windows rotated into the bounded ring")

    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def set_rate(self, hz: float) -> None:
        with self._lock:
            self.hz = float(hz)

    def start(self) -> bool:
        """Start the daemon (no-op if already running).  Enables
        thread-span tracking for the daemon's lifetime so samples carry
        trace tags."""
        from . import tracing as _tracing
        with self._lock:
            if self.running or self.hz <= 0:
                return False
            self._stop.clear()
            self._cur = ProfileWindow(self.hz)
            _tracing.enable_thread_span_tracking()
            t = threading.Thread(target=self._run, name="mxtpu-sampler",
                                 daemon=True)
            self._thread = t
        t.start()
        return True

    def stop(self, timeout: float = 2.0) -> None:
        from . import tracing as _tracing
        with self._lock:
            t, self._thread = self._thread, None
            if t is None:
                return
            self._stop.set()
        t.join(timeout)
        _tracing.disable_thread_span_tracking()
        with self._lock:
            cur, self._cur = self._cur, None
            if cur is not None and cur.samples:
                cur.close()
                self._windows.append(cur)

    def _run(self) -> None:
        me = threading.get_ident()
        next_t = perf_counter()
        while True:
            period = 1.0 / max(self.hz, 1e-3)
            next_t += period
            if self._stop.wait(max(0.0, next_t - perf_counter())):
                return
            with self._lock:
                win = self._cur
                if win is None:
                    continue
                _collect_into(win, me)
                self._c_samples.n += 1
                if win.age_s >= self.window_secs:
                    win.close()
                    self._windows.append(win)
                    self._cur = ProfileWindow(self.hz)
                    self._c_rotations.n += 1

    # -- consumption ---------------------------------------------------------
    def windows(self, include_current: bool = True
                ) -> List[ProfileWindow]:
        """Rotated windows oldest-first, plus the in-progress one."""
        with self._lock:
            out = list(self._windows)
            if include_current and self._cur is not None \
                    and self._cur.samples:
                out.append(self._cur)
        return out

    def last_window(self) -> Optional[ProfileWindow]:
        """The most recent window with samples (the postmortem's
        'what was hot just now' attachment)."""
        wins = self.windows()
        return wins[-1] if wins else None

    def collapsed(self) -> str:
        return collapsed_from_windows(self.windows())

    def clear(self) -> None:
        with self._lock:
            self._windows.clear()
            if self._cur is not None:
                self._cur = ProfileWindow(self.hz)


def profile(seconds: float = 1.0, hz: float = 100.0) -> ProfileWindow:
    """Sample synchronously for ``seconds`` on the CALLING thread (the
    ``/debug/profile?seconds=S`` handler) — independent of the daemon,
    skips the caller's own stack, returns the closed window."""
    win = ProfileWindow(hz)
    from . import tracing as _tracing
    _tracing.enable_thread_span_tracking()
    try:
        me = threading.get_ident()
        period = 1.0 / max(hz, 1e-3)
        end = perf_counter() + max(0.0, seconds)
        while True:
            _collect_into(win, me)
            if perf_counter() + period > end:
                break
            sleep(period)
    finally:
        _tracing.disable_thread_span_tracking()
    win.close()
    return win


# -- process singleton + env opt-in ------------------------------------------

_sampler_lock = threading.Lock()
_sampler_inst: Optional[StackSampler] = None


def sampler() -> StackSampler:
    """THE process-global sampler (the registry()/tracer() idiom)."""
    global _sampler_inst
    inst = _sampler_inst
    if inst is not None:
        return inst
    with _sampler_lock:
        if _sampler_inst is None:
            _sampler_inst = StackSampler()
        return _sampler_inst


# raw-env memo for maybe_start_from_env: module globals are only
# WRITTEN under _probe_lock; the fast-path read is GIL-plain
_probe_lock = threading.Lock()
_raw_hz_memo: object = object()
_hz_on = False


def maybe_start_from_env() -> bool:
    """Start (or stop) the daemon sampler to match
    ``MXTPU_PROF_SAMPLE_HZ``.  Callable from init sites at any
    frequency: while the raw environ entry is unchanged this is ONE
    dict hit (the tracing ``enabled`` idiom)."""
    global _raw_hz_memo, _hz_on
    raw = _raw_env(_HZ_KEY_B, SAMPLE_HZ_ENV)
    if raw == _raw_hz_memo:
        return _hz_on
    with _probe_lock:
        if raw == _raw_hz_memo:
            return _hz_on
        hz = float(get_env(SAMPLE_HZ_ENV) or 0.0)
        inst = sampler()
        if hz > 0:
            inst.set_rate(hz)
            inst.start()
        else:
            inst.stop()
        _raw_hz_memo = raw
        _hz_on = hz > 0
        return _hz_on
