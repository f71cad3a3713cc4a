"""Feedback controllers: close the loops the metrics spine measures.

Counterpart of ``mxnet_tpu/tuning/controllers.py``.  Each controller
reads signals the port already records and moves one knob:

==============================  =============================================
:class:`PrefetchController`     the DataLoader prefetch-depth target from
                                the ``loader.prefetch_depth`` gauge
:class:`DevicePrefetchController`  the DataLoader device-prefetch depth
                                from the ``loader.device_put_us`` tail
:class:`BatchWindowController`  ``MXTPU_SERVING_BATCH_WINDOW_US`` from
                                ``serving.queue_depth`` and the
                                ``serving.request_us`` p99
:class:`DecodeSlotController`   a ``GenerationServer``'s decode slots,
                                hill-climbed on interval tokens/s
:class:`SloController`          per-model p99 SLO defense over the front
                                door's ``ModelRegistry``: shed the lowest
                                priority first, scale the violator's
                                dispatch workers
:class:`FleetGatherController`  the multi-host metric gather, streamed on
                                the timer thread over the process group's
                                store (``dist.kv_publish``/``kv_collect``)
==============================  =============================================

Left out: ``BulkSizeController`` (the port has no bulked dispatch, so
``MXNET_ENGINE_BULK_SIZE`` means nothing there), and
``CommBucketController``, which reads the resilience layer's step times
(ROADMAP Queue A 3c).

Shared discipline (the :class:`Controller` base):

- **guard rails**: every proposal clamps to ``[vmin, vmax]`` before it can
  touch anything (clamps are counted);
- **hysteresis**: a change applies only after ``hysteresis`` consecutive
  ticks proposed a move in the same direction;
- **dry run**: ``MXTPU_TUNE_DRY_RUN`` (or the per-instance flag) computes
  and records every decision but applies nothing;
- **auditable decisions**: every decision lands in the ``tuning.*``
  metrics (``tuning.<name>.value`` gauge, ``.decisions``/``.applied``/
  ``.clamped`` counters) and as a flight-recorder tuning record.

Controllers are pull-based and tick-driven: ``tick()`` reads registry
metric deltas accumulated since the previous tick, with no wall clock
inside, so tests drive them with synthetic metric streams.  The shared
timer thread lives in :class:`..tuning.TuningRuntime`.

:class:`DecodeSlotController` keeps the JAX controller's decisions,
settle intervals and bracketing stop, whose reason there is that every
move recompiles.  In the port a move captures nothing (a step replays
the one ``DECODE_ROWS``-row decode graph once per ``DECODE_ROWS``
slots), so the settle interval only discards the step that straddles
the move.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

from ..base import get_env
from ..observability.flight import recorder as _flight_recorder
from ..observability.registry import (_percentile_from, registry,
                                      state_bounds)

__all__ = ["Controller", "PrefetchController", "BatchWindowController",
           "DecodeSlotController", "DevicePrefetchController",
           "SloController", "HistogramDelta", "CounterDelta",
           "exemplar_ids"]

DRY_RUN_ENV = "MXTPU_TUNE_DRY_RUN"


def exemplar_ids(hist, k: int = 3) -> str:
    """Comma-joined trace_ids from ``hist``'s highest (slowest)
    exemplar-carrying buckets, newest first — the concrete traces
    behind the tail a controller is steering on.  Empty when causal
    tracing is off (exemplars only exist while tracing records)."""
    ex = hist.exemplars()
    if not ex:
        return ""
    ids: List[str] = []
    for bound in sorted(ex, reverse=True):
        for tid, _v, _ts in reversed(ex[bound]):
            if tid not in ids:
                ids.append(tid)
            if len(ids) >= k:
                return ",".join(ids)
    return ",".join(ids)


class HistogramDelta:
    """Interval view over a registry Histogram: ``take()`` returns the
    aggregate of observations since the previous ``take()`` (count,
    total, p50/p99 from the bucket-count delta) — the per-tick signal a
    controller steers on, immune to the lifetime average's inertia."""

    def __init__(self, hist):
        self._h = hist
        self._last: Optional[dict] = None

    @property
    def hist(self):
        """The underlying registry Histogram (exemplar access)."""
        return self._h

    def take(self) -> Optional[dict]:
        st = self._h.state()
        last, self._last = self._last, st
        if last is None:
            return None
        counts = [a - b for a, b in zip(st["counts"], last["counts"])]
        n = st["count"] - last["count"]
        total = st["total"] - last["total"]
        if n <= 0:
            return {"count": 0, "total": 0.0, "p50": 0.0, "p99": 0.0,
                    "mean": 0.0}
        bounds = state_bounds(st)
        # lifetime min/max clamp the edge buckets — close enough for a
        # steering signal, and strictly conservative
        p50 = _percentile_from(bounds, counts, n, st["min"], st["max"],
                               50)
        p99 = _percentile_from(bounds, counts, n, st["min"], st["max"],
                               99)
        return {"count": n, "total": total, "p50": p50, "p99": p99,
                "mean": total / n}


class CounterDelta:
    """Interval view over a registry Counter (see HistogramDelta)."""

    def __init__(self, counter):
        self._c = counter
        self._last: Optional[int] = None

    def take(self) -> int:
        n = self._c.n
        last, self._last = self._last, n
        return 0 if last is None else max(0, n - last)


class Controller:
    """Base feedback controller (see module docstring for the shared
    discipline).  Subclasses implement:

    - ``current()`` — the live value of the controlled quantity;
    - ``decide()`` — ``(proposal, reason)`` from this tick's metric
      deltas, or None to hold;
    - ``apply(value)`` — actually mutate the knob/target.

    ``tick()`` runs the template: enable gate → decide → clamp to the
    guard rails → hysteresis → (dry-run-gated) apply → record the
    decision as ``tuning.*`` metrics + a flight-recorder tuning record.
    """

    #: metric namespace component (``tuning.<name>.*``) — snake_case
    name = "controller"
    #: the env knob this controller owns (documentation + decision
    #: records); None for non-knob controllers
    knob: Optional[str] = None
    #: per-controller enable knob (``MXTPU_TUNE_*``); None = always on
    enable_env: Optional[str] = None

    def __init__(self, *, vmin: float, vmax: float, hysteresis: int = 1,
                 enabled: Optional[bool] = None,
                 dry_run: Optional[bool] = None, flight=None):
        self.vmin = vmin
        self.vmax = vmax
        self.hysteresis = max(1, int(hysteresis))
        self._enabled = enabled
        self._dry_run = dry_run
        self._pending_dir = 0
        self._pending_n = 0
        self._flight = _flight_recorder() if flight is None else flight
        reg = registry()
        self._g_value = reg.gauge(
            f"tuning.{self.name}.value",
            help=f"live value of the {self.name} controller's target")
        self._c_decisions = reg.counter(
            f"tuning.{self.name}.decisions",
            help="decisions recorded (applied, held by hysteresis, or "
                 "dry-run)")
        self._c_applied = reg.counter(
            f"tuning.{self.name}.applied",
            help="decisions actually applied to the live knob/target")
        self._c_clamped = reg.counter(
            f"tuning.{self.name}.clamped",
            help="proposals clamped by the min/max guard rails — "
                 "sustained clamping means the rails disagree with the "
                 "controller's model")

    # -- knobs ---------------------------------------------------------------
    @property
    def enabled(self) -> bool:
        if self._enabled is not None:
            return self._enabled
        if self.enable_env is not None:
            return bool(get_env(self.enable_env))
        return True

    @property
    def dry_run(self) -> bool:
        if self._dry_run is not None:
            return self._dry_run
        return bool(get_env(DRY_RUN_ENV))

    # -- subclass surface ----------------------------------------------------
    def current(self) -> float:
        raise NotImplementedError

    def decide(self) -> Optional[Tuple[float, str]]:
        raise NotImplementedError

    def apply(self, value) -> None:
        raise NotImplementedError

    def on_applied(self, value) -> None:
        """Post-apply hook for search-state baselines (hill climbers
        reset their comparison score here — NOT called in dry-run, so a
        dry-run controller never believes a move it didn't make)."""

    # -- the template --------------------------------------------------------
    def tick(self) -> Optional[dict]:
        """One control decision; returns the decision record (also sent
        to metrics + flight ring) or None when holding."""
        if not self.enabled:
            return None
        out = self.decide()
        cur = self.current()
        self._g_value.set(cur)
        if out is None:
            return None
        proposal, reason = out
        clamped = min(max(proposal, self.vmin), self.vmax)
        if clamped != proposal:
            self._c_clamped.inc()
            reason += f" [clamped {proposal:g} -> {clamped:g}]"
        if clamped == cur:
            self._pending_dir = 0
            self._pending_n = 0
            return None
        direction = 1 if clamped > cur else -1
        if direction == self._pending_dir:
            self._pending_n += 1
        else:
            self._pending_dir = direction
            self._pending_n = 1
        applied = False
        held = self._pending_n < self.hysteresis
        if not held:
            self._pending_dir = 0
            self._pending_n = 0
            if not self.dry_run:
                self.apply(clamped)
                self.on_applied(clamped)
                applied = True
                self._g_value.set(clamped)
        decision = {
            "controller": self.name,
            "knob": self.knob,
            "from": cur,
            "to": clamped,
            "applied": applied,
            "held": held,
            "dry_run": self.dry_run,
            "reason": reason,
        }
        # causal audit: controllers that steer on an exemplar-carrying
        # histogram stash the tail's trace_ids in decide() — the
        # decision record then names the actual traces that drove it
        ex = getattr(self, "_tick_exemplars", "")
        if ex:
            decision["exemplars"] = ex
            self._tick_exemplars = ""
        self._c_decisions.inc()
        if applied:
            self._c_applied.inc()
        self._flight.record_tuning(**decision)
        return decision


# ---------------------------------------------------------------------------
# PrefetchController
# ---------------------------------------------------------------------------

class PrefetchController(Controller):
    """Adapt the DataLoader prefetch-depth target from the
    ``loader.prefetch_depth`` gauge (sampled at every batch handoff).

    The gauge's own help text is the policy: *near-capacity means
    workers keep ahead of the device; near-zero means the pipeline is
    starving the step*.  A starving queue gets a deeper in-flight
    window (more batches in parallel absorb worker jitter); a queue
    pinned at capacity for ``hysteresis`` consecutive ticks gets a
    shallower one (each slot is a materialized host batch — memory).
    The applied target takes effect on the next ``__iter__`` (epoch
    boundary) via :func:`..gluon.data.dataloader.
    set_prefetch_override`.

    Two guards keep the model honest:

    - an interval with fewer than ``min_batches`` loader batches holds
      — an idle (or serving-only) process's zero gauge must not read
      as starvation and ratchet the override to the rail;
    - a depth EMA *above* the target means some loader was constructed
      deeper than the controller's model — the observed depth is
      adopted as the new baseline instead of being fought down, and
      the shrink branch only ever fires once the override (this
      controller's own sizing) is live.
    """

    name = "prefetch"
    enable_env = "MXTPU_TUNE_PREFETCH"

    def __init__(self, *, vmin: int = 1, vmax: int = 64,
                 initial: int = 4, low_frac: float = 0.25,
                 high_frac: float = 0.9, ema: float = 0.5,
                 min_batches: int = 8, hysteresis: int = 2, **kw):
        super().__init__(vmin=vmin, vmax=vmax, hysteresis=hysteresis,
                         **kw)
        self.low_frac = float(low_frac)
        self.high_frac = float(high_frac)
        self.ema = float(ema)
        self.min_batches = int(min_batches)
        self._target = int(initial)
        self._depth_ema: Optional[float] = None
        reg = registry()
        self._g_depth = reg.gauge("loader.prefetch_depth")
        self._g_capacity = reg.gauge("loader.prefetch_capacity")
        self._batches = CounterDelta(reg.counter("loader.batches"))

    def current(self) -> float:
        return self._target

    def _clamp(self, v: float) -> int:
        return max(int(self.vmin), min(int(v), int(self.vmax)))

    def decide(self):
        produced = self._batches.take()
        if produced < self.min_batches:
            return None                   # idle pipeline: no evidence
        depth = self._g_depth.value
        if self._depth_ema is None:
            self._depth_ema = depth
        else:
            self._depth_ema = (self.ema * depth
                               + (1 - self.ema) * self._depth_ema)
        t = self._target
        capacity = self._g_capacity.value   # what the gauge CAN reach
        if self._depth_ema > t:
            # a loader sized deeper than our model (constructor
            # prefetch > target, override not yet applied): adopt the
            # observed depth as the baseline rather than throttling a
            # correctly-sized pipeline.  Clamped to the guard rails —
            # an unclamped adopt above vmax would later make a clamped
            # "grow" proposal read as a shrink
            self._target = self._clamp(self._depth_ema)
            return None
        if self._depth_ema <= self.low_frac * t:
            if 0 < capacity < t:
                # an applied target only takes effect at the next
                # __iter__; until the live capacity reaches it, "deep
                # starvation" is just the old small queue still in use
                # — growing again here ratchets straight to the rail
                return None
            return t * 2, (f"queue starving (depth ema "
                           f"{self._depth_ema:.1f} <= {self.low_frac} "
                           f"x {t})")
        from ..gluon.data import dataloader as _dl
        if self._depth_ema >= self.high_frac * t and t > self.vmin \
                and _dl.prefetch_override() is not None:
            return max(self.vmin, t // 2), (
                f"queue pinned at capacity (depth ema "
                f"{self._depth_ema:.1f} >= {self.high_frac} x {t})")
        return None

    def apply(self, value) -> None:
        from ..gluon.data import dataloader as _dl
        self._target = int(value)
        _dl.set_prefetch_override(self._target)


# ---------------------------------------------------------------------------
# BatchWindowController
# ---------------------------------------------------------------------------

class BatchWindowController(Controller):
    """Adapt ``MXTPU_SERVING_BATCH_WINDOW_US`` — how long the serving
    batcher waits for a shape bucket to fill — from the live
    ``serving.queue_depth`` gauge and ``serving.request_us`` p99.

    The window only matters in the middle of the load curve: under
    light load the queue never backs up and every microsecond of window
    is pure added latency — shrink it; under sustained queueing a wider
    window packs fuller batches (higher goodput per dispatch) — widen
    it, but hill-climb on the measured request p99 so a widen that
    made the tail WORSE (depth was batch-starved, not arrival-limited)
    reverses instead of compounding.  The knob is read live per batch
    by the Batcher, so an applied decision reaches a running server on
    its next assembly.
    """

    name = "batch_window"
    knob = "MXTPU_SERVING_BATCH_WINDOW_US"
    enable_env = "MXTPU_TUNE_BATCH_WINDOW"

    def __init__(self, *, vmin: float = 200.0, vmax: float = 20000.0,
                 factor: float = 2.0, min_requests: int = 20,
                 tol: float = 0.05, depth_low: float = 1.0,
                 depth_high: float = 4.0, ema: float = 0.5, **kw):
        super().__init__(vmin=vmin, vmax=vmax, **kw)
        self.factor = float(factor)
        self.min_requests = int(min_requests)
        self.tol = float(tol)
        self.depth_low = float(depth_low)
        self.depth_high = float(depth_high)
        self.ema = float(ema)
        reg = registry()
        self._req = HistogramDelta(reg.histogram("serving.request_us"))
        self._g_depth = reg.gauge("serving.queue_depth")
        self._depth_ema: Optional[float] = None
        self._last_p99: Optional[float] = None
        self._last_dir = 0

    def current(self) -> float:
        return float(get_env("MXTPU_SERVING_BATCH_WINDOW_US"))

    def decide(self):
        depth = self._g_depth.value
        if self._depth_ema is None:
            self._depth_ema = depth
        else:
            self._depth_ema = (self.ema * depth
                               + (1 - self.ema) * self._depth_ema)
        d = self._req.take()
        if d is None or d["count"] < self.min_requests:
            return None
        self._tick_exemplars = exemplar_ids(self._req.hist)
        cur = self.current()
        p99, last_p99 = d["p99"], self._last_p99
        self._last_p99 = p99
        if self._depth_ema < self.depth_low:
            self._last_dir = -1
            return cur / self.factor, (
                f"light load (depth ema {self._depth_ema:.2f} < "
                f"{self.depth_low}): shed window latency")
        if self._depth_ema >= self.depth_high:
            direction = 1
            if self._last_dir > 0 and last_p99 is not None and \
                    p99 > last_p99 * (1 + self.tol):
                direction = -1            # the widen hurt the tail
            self._last_dir = direction
            nxt = cur * self.factor if direction > 0 else \
                cur / self.factor
            return nxt, (f"queued (depth ema {self._depth_ema:.2f} >= "
                         f"{self.depth_high}) p99={p99:.0f}us "
                         f"dir={direction:+d}")
        return None

    def apply(self, value) -> None:
        # a declared-knob write is the sanctioned mutation path (the
        # env-knob lint rejects writes of UNdeclared names); the Batcher
        # reads this knob live per assembled batch
        os.environ["MXTPU_SERVING_BATCH_WINDOW_US"] = repr(float(value))


# ---------------------------------------------------------------------------
# DecodeSlotController — running-batch width for the decode scheduler
# ---------------------------------------------------------------------------

class DecodeSlotController(Controller):
    """Hill-climb a :class:`~..serving.GenerationServer`'s
    decode-slot count (the running-batch width of the iteration-level
    scheduler) on measured interval **tokens per second of decode
    time**.

    The tradeoff is real in both directions: too FEW slots and the chip
    decodes a narrow batch while admissible prompts queue (throughput
    left on the floor); too MANY and each step's gather spans a wider
    KV working set, per-step latency grows, and — with slots the
    offered load can't fill — padded rows dilute every step.  The
    optimum depends on model size, KV pool, and traffic, so it is
    searched, not configured.

    Signal: ``Δserving.tokens_generated / Δserving.decode_step_us``
    (counter delta over histogram-total delta) — tokens per second of
    decode-step wall time, wall-clock-free like every controller here,
    and immune to idle gaps between bursts (an interval with fewer
    than ``min_steps`` decode steps holds).

    The decisions are the JAX controller's: settle intervals after a
    move, and a **bracketing stop** that parks at the best measured slot
    count after two direction reversals (both neighbors measured worse),
    re-arming only when interval tokens/s decays below ``1/rearm`` of
    the best — the traffic actually changed.  (In the JAX package every
    move recompiles; in the port it captures nothing, see the module
    docstring.)  Needs a live server (``set_decode_slots`` is an
    instance surface), so it is NOT in the stock
    ``standard_controllers`` set — attach it explicitly, gated by
    ``MXTPU_TUNE_DECODE_SLOTS``."""

    name = "decode_slots"
    knob = "MXTPU_SERVING_DECODE_SLOTS"
    enable_env = "MXTPU_TUNE_DECODE_SLOTS"

    def __init__(self, server, *, vmin: int = 1, vmax: int = 64,
                 min_steps: int = 8, tol: float = 0.03,
                 settle_intervals: int = 1, rearm: float = 1.25, **kw):
        super().__init__(vmin=vmin, vmax=vmax, **kw)
        self._server = server
        self.min_steps = int(min_steps)
        self.tol = float(tol)
        self.settle_intervals = int(settle_intervals)
        self.rearm = float(rearm)
        reg = registry()
        self._step_us = HistogramDelta(
            reg.histogram("serving.decode_step_us"))
        self._tokens = CounterDelta(
            reg.counter("serving.tokens_generated"))
        self._dir = 1
        self._settle = 0
        self._flips = 0      # reversals since the last NEW best score
        self._best: Optional[float] = None
        self._best_slots: int = 0
        self._last_score: Optional[float] = None

    def current(self) -> float:
        return int(self._server.decode_slots)

    def on_applied(self, value) -> None:
        self._settle = self.settle_intervals

    def decide(self):
        d = self._step_us.take()
        tokens = self._tokens.take()
        if d is None or d["count"] < self.min_steps or tokens <= 0:
            return None
        if self._settle > 0:
            # spend the settle credit only on an interval that carried
            # steps at the new width (the step straddling the move)
            self._settle -= 1
            return None
        self._tick_exemplars = exemplar_ids(self._step_us.hist)
        cur = int(self.current())
        score = tokens / max(d["total"] / 1e6, 1e-9)   # tok/s decode time
        # the hill-climb MAXIMIZES here:
        # "regressed" = fewer tokens/s than the last interval
        new_best = self._best is None or \
            score > self._best * (1 + self.tol)
        if self._best is None or score > self._best:
            self._best = score
            self._best_slots = cur
        if self._flips < 2:
            if self._last_score is None:
                self._last_score = score  # first full interval: probe up
            elif score < self._last_score * (1 - self.tol):
                self._dir = -self._dir   # regressed: turn around
                # a recovery that merely RETURNS to the best does not
                # reset the flip count — only a NEW best does, so an
                # optimum->neighbor->optimum cycle reaches 2 flips
                self._flips += 1
                self._last_score = score
            elif score > self._last_score * (1 + self.tol):
                self._last_score = score  # improved: keep climbing
                if new_best:
                    self._flips = 0       # genuine progress re-arms
            else:
                self._last_score = score  # plateau: converged — hold
                return None
        if self._flips >= 2:
            # bracketed: both neighbors of the best width measured
            # worse — park at the best
            # until the traffic shifts, read as interval tokens/s
            # decaying well below the best
            if score < self._best / self.rearm:
                self._flips = 0
                self._best = score
                self._best_slots = cur
                self._last_score = score
                return None
            if cur != self._best_slots:
                return self._best_slots, (
                    f"bracketed (2 reversals): parking at the best "
                    f"measured width {self._best_slots} slots")
            return None
        nxt = cur * 2 if self._dir > 0 else max(1, cur // 2)
        if nxt == cur:
            nxt = cur + self._dir
        return nxt, (f"decode tok/s={score:.0f} "
                     f"step p99={d['p99']:.0f}us steps={d['count']} "
                     f"dir={self._dir:+d}")

    def apply(self, value) -> None:
        self._server.set_decode_slots(int(value))


# ---------------------------------------------------------------------------
# DevicePrefetchController — depth vs HBM
# ---------------------------------------------------------------------------

class DevicePrefetchController(Controller):
    """Adapt the DataLoader device-prefetch depth — how many batches
    stay resident on device beyond the one being consumed — from the
    ``loader.device_put_us`` transfer-dispatch distribution.

    Depth exists to absorb transfer JITTER: if every ``device_put``
    dispatches in uniform time, one buffered batch already hides the
    transfer and each extra slot is pure HBM (a full resident batch).
    A heavy dispatch tail (interval p99 ≫ p50 — host contention,
    sharding layout work, a synchronizing placement fn) means the
    consumer can catch up with the stage during a slow transfer, so
    deeper buffering earns its memory.  The applied target reaches
    every loader at its next ``__iter__`` via
    :func:`~..gluon.data.dataloader.set_device_prefetch_override`;
    the ``loader.device_buffer_depth`` gauge is the evidence a target
    is live.  An interval with fewer than ``min_batches`` transfers
    holds — an idle pipeline must not read as smooth and ratchet the
    depth to the floor.  At target 0 (the env knob off) a loader whose
    device stage is nonetheless LIVE — ``device_prefetch=`` passed to
    its constructor, visible as a nonzero buffer-depth gauge — is
    ADOPTED as the baseline (the PrefetchController idiom: observed
    reality beats the controller's model), so constructor-enabled
    pipelines get tuned too; with no live stage anywhere, 0 holds —
    off is an operator choice this controller never reverses.  Note
    the applied override wins over constructor depths at the next
    ``__iter__`` (the same process-wide semantics as the host-side
    prefetch override)."""

    name = "device_prefetch"
    knob = "MXTPU_DEVICE_PREFETCH"
    enable_env = "MXTPU_TUNE_DEVICE_PREFETCH"

    def __init__(self, *, vmin: int = 1, vmax: int = 8,
                 initial: Optional[int] = None,
                 jitter_high: float = 4.0, jitter_low: float = 1.5,
                 min_batches: int = 8, hysteresis: int = 2, **kw):
        super().__init__(vmin=vmin, vmax=vmax, hysteresis=hysteresis,
                         **kw)
        if initial is None:
            initial = int(get_env("MXTPU_DEVICE_PREFETCH"))
        self._target = max(0, int(initial))
        self.jitter_high = float(jitter_high)
        self.jitter_low = float(jitter_low)
        self.min_batches = int(min_batches)
        self._put = HistogramDelta(
            registry().histogram("loader.device_put_us"))
        self._g_depth = registry().gauge("loader.device_buffer_depth")

    def current(self) -> float:
        return self._target

    def decide(self):
        d = self._put.take()
        if d is None or d["count"] < self.min_batches:
            return None
        t = self._target
        if t <= 0:
            live = self._g_depth.value
            if live > 0:
                # a loader enabled via its CONSTRUCTOR is running a
                # device stage the env-seeded target never saw: adopt
                # the observed depth as the baseline so it gets tuned
                self._target = max(int(self.vmin),
                                   min(int(live), int(self.vmax)))
            return None                   # prefetch off (or adopting)
        jitter = d["p99"] / max(d["p50"], 1e-9)
        if jitter >= self.jitter_high:
            return t * 2, (f"transfer dispatch tail heavy (p99/p50 "
                           f"{jitter:.1f} >= {self.jitter_high}): "
                           f"deepen the double buffer")
        if jitter <= self.jitter_low and t > self.vmin:
            return t - 1, (f"transfer dispatch uniform (p99/p50 "
                           f"{jitter:.1f} <= {self.jitter_low}): "
                           f"reclaim a resident-batch slot")
        return None

    def apply(self, value) -> None:
        from ..gluon.data import dataloader as _dl
        self._target = int(value)
        _dl.set_device_prefetch_override(self._target)


# ---------------------------------------------------------------------------
# FleetGatherController — the fleet view on the timer thread
# ---------------------------------------------------------------------------

class FleetGatherController(Controller):
    """Stream the multi-host metric gather on the timer thread.

    ``snapshot(all_hosts=True)`` is a collective (every host reaches it
    in lockstep), which a free-running timer cannot promise.  This
    controller uses the barrier-free store transport instead
    (:func:`mxnet_tpu_torch.parallel.dist.kv_publish` / ``kv_collect``):
    each tick publishes this host's ``export_state()`` under a
    generation-stamped key and collects every peer's newest, with no
    wait on a peer, so hosts may tick at their own rates (a peer's view
    is at most one of its ticks stale; the ``tuning.fleet_gather.hosts``
    gauge counts the hosts seen).  The collected states feed the view the
    ``MXTPU_METRICS_AGGREGATE`` endpoint serves.

    Not a knob controller: ``tick()`` is the gather itself (counted in
    metrics; a change of the hosts seen is a decision in the flight
    recorder's tuning ring); a dry run publishes and collects but does
    not install the view.  Nothing to do without a process group.
    """

    name = "fleet_gather"
    enable_env = "MXTPU_TUNE_FLEET_GATHER"
    _KV_PREFIX = "mxtpu/fleetgather"

    def __init__(self, **kw):
        kw.setdefault("vmin", 0)
        kw.setdefault("vmax", 0)
        super().__init__(**kw)
        self._last_hosts: Optional[Tuple[int, ...]] = None
        self._g_hosts = registry().gauge(
            "tuning.fleet_gather.hosts",
            help="hosts visible in the latest barrier-free fleet "
                 "gather (this host included)")
        self._c_gathers = registry().counter(
            "tuning.fleet_gather.gathers",
            help="timer-thread fleet gathers streamed (every tick; "
                 "`.decisions` counts only membership CHANGES)")

    def current(self) -> float:
        return 0.0

    def tick(self) -> Optional[dict]:
        if not self.enabled:
            return None
        from ..parallel import dist
        if not dist.is_initialized():
            return None
        from ..observability.registry import ingest_host_states
        local = registry().export_state()
        dist.kv_publish(self._KV_PREFIX, json.dumps(local).encode("utf-8"))
        blobs = dist.kv_collect(self._KV_PREFIX)
        states: List[Tuple[int, dict]] = sorted(
            (r, json.loads(b.decode("utf-8"))) for r, b in blobs.items())
        applied = False
        if not self.dry_run and states:
            ingest_host_states(states)
            applied = True
        self._g_hosts.set(len(states))
        self._c_gathers.inc()
        hosts = tuple(r for r, _ in states)
        if hosts == self._last_hosts:
            # steady state: a record a tick would flood the flight
            # recorder's tuning ring; only a change of hosts is recorded
            return None
        self._last_hosts = hosts
        self._c_decisions.inc()
        if applied:
            self._c_applied.inc()
        decision = {
            "controller": self.name,
            "knob": None,
            "hosts": ",".join(str(r) for r in hosts),
            "applied": applied,
            "held": False,
            "dry_run": self.dry_run,
            "reason": f"fleet membership now {len(states)} host(s) in "
                      f"the KV-transport gather",
        }
        self._flight.record_tuning(**decision)
        return decision


# ---------------------------------------------------------------------------
# SloController — p99 SLO defense for the multi-model frontend
# ---------------------------------------------------------------------------

class SloController(Controller):
    """Defend per-model p99 latency SLOs on a multi-model host by
    shedding load lowest-priority-first and scaling the violating
    model's dispatch workers: a closed loop over the front door.

    One registered model per tenant, each carrying a ``priority`` and a
    ``slo_ms`` (see :class:`~..serving.registry.ModelRegistry`).
    The controller watches every SLO-carrying model's
    ``serving.model.<name>.request_us`` interval p99 — the
    socket-to-socket latency the frontend observes, i.e. what the
    client experienced, queueing included.  When a model blows its
    budget:

    - **shed** — the controlled scalar is the registry's *shed level*:
      requests for models with priority below it 429 at the door.  The
      level sheds one priority class per tick, lowest first: it rises
      to the rung *above* the lowest not-yet-shed class, capped at the
      highest-priority violator's own priority (the protected model
      itself is never shed), and steps back down one rung after
      ``recover_intervals`` consecutive intervals with every watched
      p99 under ``recover`` × its SLO — but only once the shed
      classes' arrival rate (their 429 counters' interval delta) has
      fallen under ``quiesce`` × its peak.  Watched latency looks
      healthy *because* the shed is holding, so stepping down on
      latency alone just probes the surge back in and oscillates; the
      door counters are the explicit demand signal that says the surge
      actually ended;
    - **scale** — violating predict models get their dispatch-worker
      pool doubled (up to ``workers_max``) via
      :meth:`ModelServer.set_workers`; recovery halves back toward the
      pool size the model started with.  Worker moves are side effects
      reported in the decision reason (dry-run skips them like any
      apply).

    Interval-delta driven and wall-clock-free like every controller
    here: tests tick it against synthetic latency streams.  Per-host
    instance surface (needs the live registry), so NOT in
    ``standard_controllers`` — attach explicitly, gated by
    ``MXTPU_TUNE_SLO``."""

    name = "slo"
    knob = "MXTPU_FRONTEND_SLO_MS"
    enable_env = "MXTPU_TUNE_SLO"

    def __init__(self, model_registry, *, vmin: int = 0,
                 vmax: int = 1 << 20, min_requests: int = 4,
                 recover: float = 0.6, recover_intervals: int = 2,
                 quiesce: float = 0.5, workers_max: int = 8, **kw):
        super().__init__(vmin=vmin, vmax=vmax, **kw)
        self._registry = model_registry
        self.min_requests = int(min_requests)
        self.recover = float(recover)
        self.recover_intervals = int(recover_intervals)
        self.quiesce = float(quiesce)
        self.workers_max = int(workers_max)
        self._deltas: Dict[str, HistogramDelta] = {}
        self._base_workers: Dict[str, int] = {}
        self._good = 0
        self._shed_prev = 0          # registry-wide shed-counter sum
        self._shed_peak = 0          # per-interval peak while level > 0

    def current(self) -> float:
        return int(self._registry.shed_level)

    def _delta(self, entry) -> HistogramDelta:
        d = self._deltas.get(entry.name)
        if d is None:
            d = self._deltas[entry.name] = HistogramDelta(
                entry.h_request)
        return d

    def _scale(self, entry, target: int) -> Optional[str]:
        """Move one model's worker pool (dry-run gated side effect);
        returns a reason fragment when a move happened."""
        server = entry.server
        if entry.kind != "predict" or not hasattr(server,
                                                  "set_workers"):
            return None
        cur = int(server.workers)
        self._base_workers.setdefault(entry.name, cur)
        target = max(self._base_workers[entry.name],
                     min(self.workers_max, target))
        if target == cur:
            return None
        if not self.dry_run:
            server.set_workers(target)
        return f"{entry.name}.workers {cur}->{target}"

    def decide(self):
        # demand signal first: the registry's shed counters tick for
        # every 429'd arrival, so their per-interval delta measures how
        # hard the shed classes are still knocking on the door —
        # re-admitting while that rate is near its peak would only
        # re-violate (the blind-probe oscillation), so recovery waits
        # for it to quiesce
        shed_sum = sum(int(e.c_shed.n)
                       for e in self._registry.entries())
        shed_delta = max(0, shed_sum - self._shed_prev)
        self._shed_prev = shed_sum
        cur = int(self.current())
        if cur > 0:
            self._shed_peak = max(self._shed_peak, shed_delta)
        watched = []
        for e in self._registry.entries():
            d = self._delta(e).take()     # take() every tick: no stale
            if e.slo_ms > 0 and d is not None and \
                    d["count"] >= self.min_requests:
                watched.append((e, d))
        if not watched:
            return None
        ladder = self._registry.priorities()
        violators = [(e, d) for e, d in watched
                     if d["p99"] > e.slo_ms * 1000.0]
        if violators:
            self._good = 0
            worst_e, worst_d = max(
                violators,
                key=lambda t: t[1]["p99"] / (t[0].slo_ms * 1000.0))
            self._tick_exemplars = exemplar_ids(worst_e.h_request)
            # shed lowest-priority-first, one class per tick: find the
            # lowest resident class not yet shed (strictly below the
            # protected violator — it is never shed itself), then raise
            # the level to the NEXT rung so that class 429s
            prot = max(e.priority for e, _ in violators)
            q = next((p for p in ladder if cur <= p < prot), None)
            nxt = cur if q is None else \
                next((p for p in ladder if q < p <= prot), prot)
            moves = [m for m in (self._scale(
                e, int(getattr(e.server, "workers", 0)) * 2)
                for e, _ in violators) if m]
            reason = (f"{worst_e.name} p99={worst_d['p99'] / 1e3:.2f}ms "
                      f"> slo={worst_e.slo_ms:g}ms "
                      f"(n={worst_d['count']})")
            if moves:
                reason += " scaled " + ",".join(moves)
            if nxt != cur:
                return nxt, reason
            # shed level already at the cap: the worker moves above
            # are the whole response this tick
            return None
        if all(d["p99"] < e.slo_ms * 1000.0 * self.recover
               for e, d in watched):
            self._good += 1
            # latency alone is not enough to step the level down — it
            # only looks healthy BECAUSE the shed is holding.  The gate
            # is the demand signal: re-admit once the shed classes'
            # arrival rate has fallen under ``quiesce`` x its peak
            # (_good keeps accumulating while the gate holds, so the
            # step-down lands on the first quiesced tick)
            if self._good >= self.recover_intervals and \
                    (cur == 0 or
                     shed_delta <= self.quiesce * self._shed_peak):
                self._good = 0
                moves = [m for m in (self._scale(
                    e, max(self._base_workers.get(e.name, 1),
                           int(getattr(e.server, "workers", 1)) // 2))
                    for e, _ in watched) if m]
                nxt = max([p for p in ladder if p < cur], default=0) \
                    if cur > 0 else 0
                if nxt == 0:
                    self._shed_peak = 0
                reason = ("all watched p99 < "
                          f"{self.recover:g}x slo for "
                          f"{self.recover_intervals} intervals, shed "
                          f"demand quiesced ({shed_delta}/interval)")
                if moves:
                    reason += " scaled " + ",".join(moves)
                if nxt != cur:
                    return nxt, reason
            return None
        self._good = 0
        return None

    def apply(self, value) -> None:
        self._registry.set_shed_level(int(value))
