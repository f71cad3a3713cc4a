"""Progress watchdog: detect silent hangs and dump one postmortem.

Counterpart of ``mxnet_tpu/observability/watchdog.py``.  A wedged
server does not crash: it goes silent, and every after-the-fact
recorder keeps humming with stale data.  Three pieces:

- **Touchpoints** (:class:`Touchpoint`): heartbeat counters bumped from
  the progress loops that matter: the ``ModelServer`` dispatch workers
  (``serving.dispatch``) and the ``GenerationServer`` decode loop
  (``serving.decode``).  A beat is one attribute increment.
- **The monitor** (:class:`Watchdog`): a daemon thread ticking every
  ``interval_s``.  All silence math lives in :meth:`Watchdog.tick`
  ``(dt)`` and runs on accumulated tick time, never the wall clock, so
  tests drive the whole arc with synthetic ``dt``.  A touchpoint is
  stalled when it goes silent for ``MXTPU_WATCHDOG_FACTOR`` × its own
  recent p99 interval, taken from the histogram its loop feeds (a
  bucket-count delta, with a lifetime fallback), floored at
  :data:`MIN_THRESHOLD_S`.
- **The postmortem** (:func:`build_postmortem`): on the first stall of
  a quiet period (re-armed once every stalled touchpoint progresses
  again) the watchdog writes one bundle through the flight recorder's
  atomic writer: all-thread stacks (trace-tagged), the four flight
  rings, the span ring, the active cross-thread spans, the sampler's
  last window and a registry snapshot.  ``watchdog.stalls`` counts
  detections; ``MXTPU_WATCHDOG_ACTION=term`` also SIGTERMs the process
  so the drain handlers take over.

Also here: :func:`install_stack_signal`, the manual probe.  SIGQUIT (or
``MXTPU_STACKS_SIGNAL``) dumps all-thread stacks and the flight rings to
a flight-adjacent path without killing the process, chaining the
previous handler; :func:`uninstall_stack_signal` puts that handler back.
"""
from __future__ import annotations

import os
import signal
import sys
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional

from ..base import get_env
from .registry import _percentile_from, host_id, registry, state_bounds

__all__ = ["Touchpoint", "Watchdog", "watchdog", "touchpoint",
           "build_postmortem", "install_stack_signal",
           "uninstall_stack_signal",
           "WATCHDOG_FACTOR_ENV", "WATCHDOG_ACTION_ENV",
           "STACKS_SIGNAL_ENV"]

WATCHDOG_FACTOR_ENV = "MXTPU_WATCHDOG_FACTOR"
WATCHDOG_ACTION_ENV = "MXTPU_WATCHDOG_ACTION"
STACKS_SIGNAL_ENV = "MXTPU_STACKS_SIGNAL"

#: silence floor (seconds): progress loops beat on idle timeouts every
#: 0.1-0.25s, so a sub-second p99 × factor could flag a merely-idle
#: loop — no stall below this is ever actionable
MIN_THRESHOLD_S = 1.0

#: p99 snapshot refresh cadence (accumulated tick seconds): the delta
#: window the "recent p99 interval" is computed over
SNAP_REFRESH_S = 60.0


class Touchpoint:
    """One heartbeat: a progress loop bumps :attr:`n` (``tp.beat()`` is
    a single attribute increment — GIL-atomic, allocation-free, safe on
    dispatch hot paths); the monitor compares successive values.
    ``hist`` names the registry histogram whose observations are this
    loop's per-beat durations — the spine the stall threshold is
    computed from."""

    __slots__ = ("name", "hist", "n")

    def __init__(self, name: str, hist: Optional[str] = None):
        self.name = name
        self.hist = hist
        self.n = 0

    def beat(self) -> None:
        self.n += 1


class Watchdog:
    """The monitor.  Constructor args override the env knobs for tests;
    ``kill_fn`` injects the ``term`` action (default: SIGTERM self, so
    the serving/trainer drain handlers run)."""

    def __init__(self, factor: Optional[float] = None,
                 action: Optional[str] = None,
                 interval_s: float = 0.5,
                 floor_s: float = MIN_THRESHOLD_S,
                 snap_refresh_s: float = SNAP_REFRESH_S,
                 path: Optional[str] = None,
                 kill_fn: Optional[Callable[[], None]] = None):
        self._factor = factor
        self._action = action
        self.interval_s = float(interval_s)
        self.floor_s = float(floor_s)
        self.snap_refresh_s = float(snap_refresh_s)
        self.path = path
        self._kill = kill_fn
        self._touchpoints: Dict[str, Touchpoint] = {}
        self._state: Dict[str, dict] = {}
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self._dumped = False
        self.last_postmortem: Optional[str] = None
        reg = registry()
        self._c_stalls = reg.counter(
            "watchdog.stalls",
            help="touchpoints flagged stalled (silent past factor x "
                 "their recent p99 interval)")
        self._c_postmortems = reg.counter(
            "watchdog.postmortems",
            help="postmortem bundles written (dump-once per quiet "
                 "period)")

    # -- knobs ---------------------------------------------------------------
    @property
    def factor(self) -> float:
        if self._factor is not None:
            return float(self._factor)
        try:
            return float(get_env(WATCHDOG_FACTOR_ENV) or 0.0)
        except (TypeError, ValueError):
            return 0.0

    @property
    def action(self) -> str:
        if self._action is not None:
            return str(self._action)
        return str(get_env(WATCHDOG_ACTION_ENV) or "dump").strip().lower()

    # -- touchpoints ---------------------------------------------------------
    def touchpoint(self, name: str, hist: Optional[str] = None
                   ) -> Touchpoint:
        """Get-or-create the named touchpoint (idempotent: re-inits —
        trainer restarts, server rebuilds — reuse the heartbeat)."""
        with self._lock:
            tp = self._touchpoints.get(name)
            if tp is None:
                tp = Touchpoint(name, hist)
                self._touchpoints[name] = tp
                self._state[name] = {"last_n": 0, "silent_s": 0.0,
                                     "fired": False, "snap": None,
                                     "snap_age": 0.0, "hist_obj": None,
                                     "p99_us": None}
            elif hist and tp.hist is None:
                tp.hist = hist
        return tp

    def touchpoints(self) -> List[dict]:
        """Live view for ``/debug``: per-touchpoint beat count,
        silence, threshold inputs."""
        with self._lock:
            names = list(self._touchpoints)
        out = []
        for name in names:
            tp = self._touchpoints.get(name)
            st = self._state.get(name)
            if tp is None or st is None:
                continue
            out.append({"touchpoint": name, "beats": tp.n,
                        "hist": tp.hist,
                        "silent_s": round(st["silent_s"], 3),
                        "fired": st["fired"],
                        "p99_us": st["p99_us"]})
        return out

    # -- threshold math (wall-clock-free: everything runs on tick dt) -------
    def _hist_for(self, tp: Touchpoint, st: dict):
        if tp.hist is None:
            return None
        h = st["hist_obj"]
        if h is None:
            h = registry().histogram(tp.hist)
            st["hist_obj"] = h
        return h

    def _recent_p99_us(self, tp: Touchpoint, st: dict
                       ) -> Optional[float]:
        """The touchpoint's recent p99 beat duration from its spine
        histogram: bucket-count delta since the last snapshot refresh
        (the HistogramDelta idiom) when the delta has data, lifetime
        p99 otherwise; None when the histogram never observed (the
        loop hasn't produced a single beat duration — nothing to
        compare silence against)."""
        h = self._hist_for(tp, st)
        if h is None:
            return None
        state = h.state()
        if state["count"] <= 0:
            return None
        snap = st["snap"]
        bounds = state_bounds(state)
        if snap is not None:
            delta_n = state["count"] - snap["count"]
            if delta_n > 0:
                counts = [a - b for a, b in
                          zip(state["counts"], snap["counts"])]
                p99 = _percentile_from(bounds, counts, delta_n,
                                       state["min"], state["max"], 99)
                st["p99_us"] = p99
                return p99
        p99 = _percentile_from(bounds, state["counts"], state["count"],
                               state["min"], state["max"], 99)
        st["p99_us"] = p99
        return p99

    def _exemplar_trace_ids(self, tp: Touchpoint, st: dict, k: int = 3
                            ) -> List[str]:
        """trace_ids from the spine histogram's slowest exemplar
        buckets, newest first — the concrete recent executions of the
        now-silent loop (empty when tracing is off)."""
        h = self._hist_for(tp, st)
        if h is None:
            return []
        try:
            ex = h.exemplars()
        except Exception:   # noqa: BLE001 — introspection only
            return []
        ids: List[str] = []
        for bound in sorted(ex, reverse=True):
            for tid, _v, _ts in reversed(ex[bound]):
                if tid not in ids:
                    ids.append(tid)
                if len(ids) >= k:
                    return ids
        return ids

    def tick(self, dt: float) -> List[dict]:
        """One monitor pass, advancing every touchpoint's silence clock
        by ``dt`` seconds.  Returns the touchpoints that NEWLY crossed
        their stall threshold this tick (after dump/action handling).
        Pure in time: calling ``tick(0.5)`` twelve times is exactly six
        seconds of monitoring, no wall clock consulted."""
        factor = self.factor
        if factor <= 0:
            return []
        with self._lock:
            items = [(tp, self._state[tp.name])
                     for tp in self._touchpoints.values()]
        newly: List[dict] = []
        any_stalled = False
        for tp, st in items:
            n = tp.n
            if n != st["last_n"]:
                st["last_n"] = n
                st["silent_s"] = 0.0
                st["fired"] = False
                st["snap_age"] += dt
                if st["snap"] is None \
                        or st["snap_age"] >= self.snap_refresh_s:
                    h = self._hist_for(tp, st)
                    if h is not None:
                        st["snap"] = h.state()
                    st["snap_age"] = 0.0
                continue
            if n == 0:
                continue   # never beat: the loop hasn't started
            st["silent_s"] += dt
            p99_us = self._recent_p99_us(tp, st)
            if p99_us is None:
                continue
            threshold_s = max(factor * p99_us / 1e6, self.floor_s)
            if st["silent_s"] < threshold_s:
                continue
            any_stalled = True
            if st["fired"]:
                continue
            st["fired"] = True
            self._c_stalls.inc()
            newly.append({"touchpoint": tp.name,
                          "beats": n,
                          "silent_s": round(st["silent_s"], 3),
                          "threshold_s": round(threshold_s, 3),
                          "p99_us": round(p99_us, 1),
                          "factor": factor,
                          "recent_trace_ids":
                              self._exemplar_trace_ids(tp, st)})
        if newly and not self._dumped:
            # dump-once dedup: one bundle per quiet period — a second
            # touchpoint starving behind the same hang (decode stalls
            # because dispatch stalled) must not overwrite the bundle
            # that shows the original stall
            self._dumped = True
            self._fire(newly)
        if not any_stalled and self._dumped:
            self._dumped = False   # everything progressed: re-arm
        return newly

    def _fire(self, stalled: List[dict]) -> None:
        names = ",".join(s["touchpoint"] for s in stalled)
        path = self._dump_postmortem(f"watchdog stall: {names}", stalled)
        if self.action == "term":
            kill = self._kill
            if kill is None:
                os.kill(os.getpid(), signal.SIGTERM)
            else:
                kill()
        else:
            _ = path

    def _dump_postmortem(self, reason: str, stalled: List[dict]
                         ) -> Optional[str]:
        from . import flight as _flight
        bundle = build_postmortem(reason, stalled)
        path = self.path
        if path is None:
            try:
                path = _flight.recorder().sibling_path("postmortem")
            except Exception:   # noqa: BLE001 — fall back to tmp
                path = os.path.join(tempfile.gettempdir(),
                                    f"mxtpu_postmortem_{os.getpid()}.json")
        out = _flight.write_json_atomic(bundle, path)
        if out is not None:
            self.last_postmortem = out
            self._c_postmortems.inc()
            try:
                print(f"mxnet_tpu_torch watchdog: wrote postmortem to {out} "
                      f"({reason})", file=sys.stderr)
            except Exception:   # noqa: BLE001 — bookkeeping only
                pass
        return out

    # -- monitor thread ------------------------------------------------------
    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def start(self) -> bool:
        """Start the monitor daemon (idempotent).  Enables cross-thread
        span tracking for its lifetime so postmortems carry the active
        spans."""
        from . import tracing as _tracing
        with self._lock:
            if self.running:
                return False
            self._stop_evt.clear()
            _tracing.enable_thread_span_tracking()
            t = threading.Thread(target=self._run,
                                 name="mxtpu-watchdog", daemon=True)
            self._thread = t
        t.start()
        return True

    def stop(self, timeout: float = 2.0) -> None:
        from . import tracing as _tracing
        with self._lock:
            t, self._thread = self._thread, None
            if t is None:
                return
            self._stop_evt.set()
        t.join(timeout)
        _tracing.disable_thread_span_tracking()

    def _run(self) -> None:
        while not self._stop_evt.wait(self.interval_s):
            try:
                self.tick(self.interval_s)
            except Exception:   # noqa: BLE001 — the watchdog must
                pass            # never take down the watched job


def build_postmortem(reason: str,
                     stalled: Optional[List[dict]] = None) -> dict:
    """Assemble the full hang-postmortem bundle: stacks + flight rings
    + span ring + active spans + last profile window + registry
    snapshot.  Every section is best-effort — a half-wedged process
    still yields whatever it can."""
    bundle: dict = {"reason": reason,
                    "ts": round(time.time(), 3),
                    "host": host_id(),
                    "pid": os.getpid(),
                    "stalled": stalled or []}
    from . import sampler as _sampler
    try:
        bundle["stacks"] = _sampler.thread_stacks()
    except Exception:   # noqa: BLE001 — best-effort section
        bundle["stacks"] = []
    try:
        from . import flight as _flight
        bundle["flight"] = _flight.recorder().live()
    except Exception:   # noqa: BLE001 — best-effort section
        bundle["flight"] = {}
    try:
        from . import tracing as _tracing
        bundle["trace_spans"] = _tracing.tracer().spans()
        bundle["active_spans"] = {
            str(ident): {"trace_id": getattr(sp, "trace_id", None),
                         "span": getattr(sp, "name", None)}
            for ident, sp in _tracing.thread_spans().items()}
    except Exception:   # noqa: BLE001 — best-effort section
        bundle["trace_spans"] = []
        bundle["active_spans"] = {}
    try:
        win = _sampler.sampler().last_window()
        if win is not None:
            bundle["profile"] = win.to_dict()
            bundle["profile"]["collapsed"] = win.collapsed()
    except Exception:   # noqa: BLE001 — best-effort section
        pass
    try:
        bundle["snapshot"] = registry().snapshot()
    except Exception:   # noqa: BLE001 — best-effort section
        bundle["snapshot"] = {}
    return bundle


# -- manual stack-dump signal -------------------------------------------------

_signal_installed = False
_signal_prev = None       # (signal, the handler it had before ours)


def _dump_stacks_bundle() -> Optional[str]:
    """Stacks + flight rings to a flight-adjacent path (the signal
    handler's payload; also directly callable)."""
    from . import flight as _flight
    from . import sampler as _sampler
    bundle: dict = {"reason": "stack signal",
                    "ts": round(time.time(), 3),
                    "host": host_id(),
                    "pid": os.getpid()}
    try:
        bundle["stacks"] = _sampler.thread_stacks()
    except Exception:   # noqa: BLE001 — best-effort section
        bundle["stacks"] = []
    try:
        rec = _flight.recorder()
        bundle["flight"] = rec.live()
        path = rec.sibling_path("stacks")
    except Exception:   # noqa: BLE001 — best-effort section
        bundle["flight"] = {}
        path = os.path.join(tempfile.gettempdir(),
                            f"mxtpu_stacks_{os.getpid()}.json")
    out = _flight.write_json_atomic(bundle, path)
    if out is not None:
        try:
            print(f"mxnet_tpu_torch: wrote thread stacks to {out}",
                  file=sys.stderr)
        except Exception:   # noqa: BLE001 — bookkeeping only
            pass
    return out


def install_stack_signal() -> bool:
    """Install the ``MXTPU_STACKS_SIGNAL`` (default SIGQUIT) handler:
    dump all-thread stacks + flight rings WITHOUT dying, then chain the
    previous handler (the serving SIGTERM-drain chaining discipline, so
    stacking this on an already-handled signal keeps both behaviors).
    Idempotent; returns False when disabled (empty knob), the name is
    unknown, or installation is impossible (non-main thread).
    :func:`uninstall_stack_signal` restores the previous handler."""
    global _signal_installed, _signal_prev
    name = str(get_env(STACKS_SIGNAL_ENV) or "").strip()
    if not name:
        return False
    if _signal_installed:
        return True
    sig = getattr(signal, name, None)
    if not isinstance(sig, signal.Signals):
        return False
    prev = signal.getsignal(sig)

    def _handler(signum, frame):
        # the dump walks every thread and reads device values — never
        # do that inside a signal frame; hand it to a thread and return
        # at once (the install_sigterm drain-thread shape)
        threading.Thread(target=_dump_stacks_bundle,
                         name="mxtpu-stacks-dump", daemon=True).start()
        if callable(prev) and prev not in (signal.SIG_IGN,
                                           signal.SIG_DFL):
            try:
                prev(signum, frame)
            except Exception:   # noqa: BLE001 — a broken chained
                pass            # handler must not kill the dump

    try:
        signal.signal(sig, _handler)
    except ValueError:   # not the main thread
        return False
    _signal_installed = True
    _signal_prev = (sig, prev)
    return True


def uninstall_stack_signal() -> bool:
    """Put back the handler :func:`install_stack_signal` chained (from
    the main thread).  Returns False when nothing was installed or the
    restore is impossible (non-main thread)."""
    global _signal_installed, _signal_prev
    if not _signal_installed or _signal_prev is None:
        return False
    sig, prev = _signal_prev
    try:
        signal.signal(sig, prev if prev is not None else signal.SIG_DFL)
    except ValueError:   # not the main thread
        return False
    _signal_installed = False
    _signal_prev = None
    return True


# -- process singleton + env opt-in ------------------------------------------

_watchdog_lock = threading.Lock()
_watchdog_inst: Optional[Watchdog] = None


def watchdog() -> Watchdog:
    """THE process-global watchdog (the registry()/tracer() idiom)."""
    global _watchdog_inst
    inst = _watchdog_inst
    if inst is not None:
        return inst
    with _watchdog_lock:
        if _watchdog_inst is None:
            _watchdog_inst = Watchdog()
        return _watchdog_inst


def touchpoint(name: str, hist: Optional[str] = None) -> Touchpoint:
    """Register (or fetch) a heartbeat touchpoint on the global
    watchdog and start the monitor when ``MXTPU_WATCHDOG_FACTOR`` > 0
    — the one-liner the progress loops call at init."""
    wd = watchdog()
    tp = wd.touchpoint(name, hist)
    if wd.factor > 0 and not wd.running:
        wd.start()
    return tp
