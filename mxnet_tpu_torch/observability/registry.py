"""Process-global metrics registry: Counter / Gauge / Histogram.

Counterpart of ``mxnet_tpu/observability/registry.py``, whole:
get-or-create metrics under namespaced dotted names, lock-exact counter
increments, fixed log-scale histograms (``bounds[i] = base * growth**i``,
10 buckets per decade by default) whose percentiles resolve to one bucket,
``snapshot()`` (every metric in one dict), the raw mergeable ``state()``
each metric exports, and histogram **exemplars**: while causal tracing is
on (``observability.tracing`` installs the hook) every ``observe`` keeps
the observing trace's id in its bucket, the last ``EXEMPLAR_K`` a bucket,
so a p99 bucket points at real traces.

The cost discipline is the JAX package's: a counter bump is an int add
under a lock (hot loops may bump ``counter.n`` directly), a histogram
observation a bisect and a few adds; formatting happens only when
something reads.

The fleet view is a set of pure functions over per-host states
(``merge_host_states``, ``group_host_entries``, ``state_bounds``,
``state_cumulative_buckets``, ``ingest_host_states``).  ``host_id()`` is
the ``torch.distributed`` rank when a process group is up, else 0.
``gather_host_states`` (and ``snapshot(all_hosts=True)``) gathers every
host's ``export_state()`` as JSON over ``parallel.dist.allgather_bytes``,
a collective, as the JAX package does; without a process group it serves
this host alone, labeled with its ``host_id``.
"""
from __future__ import annotations

import json
import re
import threading
import time as _time
from bisect import bisect_left
from typing import Callable, Dict, List, Optional, Tuple, Union

from ..base import MXNetError

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "registry",
           "host_id", "gather_host_states", "last_host_states",
           "ingest_host_states", "merge_host_states",
           "group_host_entries", "state_bounds",
           "state_cumulative_buckets", "set_exemplar_trace_hook"]

# -- histogram exemplars (causal tracing) ------------------------------------
#
# When the tracing layer is live it installs a hook returning the ACTIVE
# trace_id (or None); every Histogram.observe then records that id into
# the observed bucket (last-EXEMPLAR_K per bucket), so a histogram's p99
# bucket points at real traces instead of an anonymous count.  With no
# hook installed (tracing never imported/enabled) observe pays exactly
# one module-global read over its pre-exemplar cost.

EXEMPLAR_K = 4

_exemplar_trace_hook: Optional[Callable[[], Optional[str]]] = None


def set_exemplar_trace_hook(fn: Optional[Callable[[], Optional[str]]]
                            ) -> None:
    """Install (or clear, with None) the active-trace-id provider the
    tracing layer exposes; :func:`.tracing.tracer` is its one caller."""
    global _exemplar_trace_hook
    _exemplar_trace_hook = fn

# namespaced dotted names: `engine.ops_dispatched`, `loader.batches`, ...
_NAME_RE = re.compile(r"^[a-z_][a-z0-9_]*(\.[a-z0-9_]+)+$")


class Counter:
    """Monotonic event count.  ``inc()`` is the lock-exact path; hot
    loops may bump ``.n`` directly (see module docstring)."""

    __slots__ = ("name", "n", "help", "_lock")
    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.n = 0
        self.help = help
        self._lock = threading.Lock()

    def inc(self, amount: int = 1) -> None:
        with self._lock:
            self.n += amount

    @property
    def value(self) -> int:
        return self.n

    def reset(self) -> None:
        with self._lock:
            self.n = 0

    def read(self) -> int:
        return self.n

    def __repr__(self) -> str:
        return f"Counter({self.name}={self.n})"


class Gauge:
    """Last-write-wins instantaneous value (queue depth, loss scale)."""

    __slots__ = ("name", "_v", "help", "_lock")
    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self._v = 0.0
        self.help = help
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        self._v = float(value)

    @property
    def value(self) -> float:
        return self._v

    def reset(self) -> None:
        self._v = 0.0

    def read(self) -> float:
        return self._v

    def __repr__(self) -> str:
        return f"Gauge({self.name}={self._v})"


def _percentile_from(bounds, counts, count, vmin, vmax, q: float) -> float:
    """Bucket-percentile math shared by live Histograms and merged
    multi-host states: the containing bucket's upper bound, clamped to
    the observed min/max so edge buckets don't overstate."""
    if not count:
        return 0.0
    rank = max(1, int(round(q / 100.0 * count)))
    acc = 0
    for i, c in enumerate(counts):
        acc += c
        if acc >= rank:
            if i >= len(bounds):              # overflow bucket
                return float(vmax)
            hi = bounds[i]
            lo = vmin if vmin is not None else hi
            return float(min(max(hi, lo), vmax))
    return float(vmax)


def _aggregate_from(bounds, counts, count, total, vmin, vmax) -> dict:
    """The ``read()``-style aggregate dict from raw bucket state."""
    return {
        "count": count,
        "sum": round(total, 3),
        "mean": round(total / count, 3) if count else 0.0,
        "min": round(vmin, 3) if vmin is not None else 0.0,
        "max": round(vmax, 3) if vmax is not None else 0.0,
        "p50": round(_percentile_from(bounds, counts, count, vmin, vmax,
                                      50), 3),
        "p90": round(_percentile_from(bounds, counts, count, vmin, vmax,
                                      90), 3),
        "p99": round(_percentile_from(bounds, counts, count, vmin, vmax,
                                      99), 3),
    }


class Histogram:
    """Fixed log-scale-bucket histogram (see module docstring).

    ``counts[i]`` counts observations with ``v <= bounds[i]`` (and above
    ``bounds[i-1]``); ``counts[-1]`` is the overflow bucket.  All updates
    happen under one lock — a handful of int/float adds, no formatting.
    """

    __slots__ = ("name", "base", "growth", "bounds", "counts", "count",
                 "total", "vmin", "vmax", "help", "_lock", "_ex")
    kind = "histogram"

    def __init__(self, name: str, base: float = 1.0,
                 growth: float = 10.0 ** 0.1, buckets: int = 120,
                 help: str = ""):
        if base <= 0 or growth <= 1.0 or buckets < 1:
            raise MXNetError(
                f"Histogram {name!r}: need base > 0, growth > 1, "
                f"buckets >= 1 (got {base}, {growth}, {buckets})")
        self.name = name
        self.base = float(base)
        self.growth = float(growth)
        self.bounds: Tuple[float, ...] = tuple(
            base * growth ** i for i in range(buckets))
        self.counts: List[int] = [0] * (buckets + 1)
        self.count = 0
        self.total = 0.0
        self.vmin: Optional[float] = None
        self.vmax: Optional[float] = None
        self.help = help
        self._lock = threading.Lock()
        # bucket index -> [(trace_id, value, wall_ts), ...] last-K, only
        # ever populated while the tracing exemplar hook is installed
        self._ex: Optional[Dict[int, list]] = None

    def observe(self, value: float,
                trace_id: Optional[str] = None) -> None:
        i = bisect_left(self.bounds, value)
        hook = _exemplar_trace_hook
        with self._lock:
            self.counts[i] += 1
            self.count += 1
            self.total += value
            if self.vmin is None or value < self.vmin:
                self.vmin = value
            if self.vmax is None or value > self.vmax:
                self.vmax = value
            if hook is not None:
                tid = trace_id if trace_id is not None else hook()
                if tid:
                    ex = self._ex
                    if ex is None:
                        ex = self._ex = {}
                    lst = ex.get(i)
                    if lst is None:
                        ex[i] = lst = []
                    lst.append((tid, value, round(_time.time(), 3)))
                    if len(lst) > EXEMPLAR_K:
                        lst.pop(0)

    def exemplars(self) -> Dict[float, list]:
        """Recorded exemplars keyed by bucket UPPER BOUND (``inf`` for
        the overflow bucket): ``{bound: [(trace_id, value, ts), ...]}``
        newest last.  The resolution path for a tail outlier: p99 bucket
        → trace_id → the span ring (:meth:`.tracing.Tracer.find`)."""
        with self._lock:
            if not self._ex:
                return {}
            n = len(self.bounds)
            return {(self.bounds[i] if i < n else float("inf")): list(lst)
                    for i, lst in self._ex.items()}

    def percentile(self, q: float) -> float:
        """Approximate q-th percentile (q in [0, 100]) from the buckets.
        Resolution = one bucket (±(growth-1)/2 relative)."""
        with self._lock:
            return _percentile_from(self.bounds, self.counts, self.count,
                                    self.vmin, self.vmax, q)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def reset(self) -> None:
        with self._lock:
            self.counts = [0] * len(self.counts)
            self.count = 0
            self.total = 0.0
            self.vmin = None
            self.vmax = None
            self._ex = None

    def read(self) -> dict:
        """Aggregate view (the snapshot() value for histograms)."""
        with self._lock:
            counts = list(self.counts)
            count, total = self.count, self.total
            vmin, vmax = self.vmin, self.vmax
        return _aggregate_from(self.bounds, counts, count, total, vmin,
                               vmax)

    def state(self) -> dict:
        """Raw, merge-able state (JSON-serializable): the unit the fleet
        view merges.  ``base``/``growth`` travel
        along so a peer can rebuild the bounds and refuse to merge a
        histogram whose bucketing differs."""
        with self._lock:
            return {"kind": "histogram", "base": self.base,
                    "growth": self.growth, "counts": list(self.counts),
                    "count": self.count, "total": self.total,
                    "min": self.vmin, "max": self.vmax, "help": self.help}

    def cumulative_buckets(self) -> List[Tuple[float, int]]:
        """(upper_bound, cumulative_count) pairs for Prometheus-style
        export; the final pair is (inf, total_count).  Empty buckets with
        no observations at or above them are elided to keep scrapes
        small."""
        out: List[Tuple[float, int]] = []
        with self._lock:
            acc = 0
            for i, c in enumerate(self.counts[:-1]):
                acc += c
                if c:
                    out.append((self.bounds[i], acc))
            out.append((float("inf"), self.count))
        return out

    def __repr__(self) -> str:
        return f"Histogram({self.name}, n={self.count})"


_Metric = Union[Counter, Gauge, Histogram]


class MetricsRegistry:
    """Thread-safe name → metric map.  ``counter``/``gauge``/``histogram``
    get-or-create (idempotent — every call site can ask for its metric
    without coordination); asking for an existing name with a different
    type is always a bug and raises."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, name: str, cls, **kwargs) -> _Metric:
        m = self._metrics.get(name)       # lock-free fast path (GIL dict)
        if m is not None:
            if type(m) is not cls:
                raise MXNetError(
                    f"metric {name!r} is already registered as a "
                    f"{type(m).__name__}, not a {cls.__name__}")
            if kwargs.get("help") and not m.help:
                # a later call site may carry the description the first
                # (hot-path) registration omitted
                m.help = kwargs["help"]
            return m
        if not _NAME_RE.match(name):
            raise MXNetError(
                f"bad metric name {name!r}: use namespaced lowercase "
                f"dotted names like 'engine.ops_dispatched'")
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, **kwargs)
                self._metrics[name] = m
            elif type(m) is not cls:
                raise MXNetError(
                    f"metric {name!r} is already registered as a "
                    f"{type(m).__name__}, not a {cls.__name__}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(name, Counter, help=help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(name, Gauge, help=help)

    def histogram(self, name: str, **kwargs) -> Histogram:
        return self._get_or_create(name, Histogram, **kwargs)

    def get(self, name: str) -> Optional[_Metric]:
        return self._metrics.get(name)

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def snapshot(self, all_hosts: bool = False) -> dict:
        """Every metric in ONE dict: counters → int, gauges → float,
        histograms → their aggregate sub-dict.  The single pull surface
        the exporters and tests read.

        ``all_hosts=True`` is the fleet view: every host's state gathered
        (a collective: every process calls it together, e.g. at a
        checkpoint boundary) and merged, counters summed, histogram
        buckets added, every series with a ``host`` map; this host alone
        without a process group (see :func:`gather_host_states`)."""
        if all_hosts:
            return merge_host_states(gather_host_states(self))
        with self._lock:
            items = sorted(self._metrics.items())
        return {name: m.read() for name, m in items}

    def export_state(self) -> dict:
        """Raw per-metric state (JSON-serializable): what one host
        contributes to the fleet view."""
        with self._lock:
            items = sorted(self._metrics.items())
        out = {}
        for name, m in items:
            if isinstance(m, Counter):
                out[name] = {"kind": "counter", "n": m.n, "help": m.help}
            elif isinstance(m, Gauge):
                out[name] = {"kind": "gauge", "v": m.value,
                             "help": m.help}
            else:
                out[name] = m.state()
        return out

    def reset(self, prefix: str = "") -> None:
        """Zero every metric under ``prefix`` ('' = all) — test harness /
        benchmark epoch boundaries."""
        with self._lock:
            targets = [m for name, m in self._metrics.items()
                       if name.startswith(prefix)]
        for m in targets:
            m.reset()


_registry_lock = threading.Lock()
_registry_inst: Optional[MetricsRegistry] = None


def registry() -> MetricsRegistry:
    """The process-global registry."""
    global _registry_inst
    inst = _registry_inst          # lock-free fast path: set-once
    if inst is not None:
        return inst
    with _registry_lock:
        if _registry_inst is None:
            _registry_inst = MetricsRegistry()
        return _registry_inst


# -- multi-host aggregation (the fleet view) --------------------------------
#
# Per-host registries stay strictly local (producers never pay a network
# cost); the fleet view merges per-host export_state() dicts.  Nothing
# here runs a collective from a scrape handler: the Prometheus AGGREGATE
# mode serves the most recently installed states (see export.py).

_last_host_states: Optional[List[Tuple[int, dict]]] = None


def host_id() -> int:
    """This process's index in the fleet: the ``torch.distributed`` rank
    when a process group is up, else 0."""
    try:
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            return int(dist.get_rank())
    except (ImportError, RuntimeError, ValueError):
        pass            # a broken probe must not break local metrics
    return 0


def gather_host_states(reg: Optional[MetricsRegistry] = None
                       ) -> List[Tuple[int, dict]]:
    """``(host_index, export_state())`` of every process: a collective
    over ``parallel.dist.allgather_bytes`` when the process group is up,
    this host alone otherwise.  A successful gather is kept for
    :func:`last_host_states` (the aggregate endpoint serves it between
    gathers); a failed one warns and serves the local view."""
    global _last_host_states
    reg = reg if reg is not None else registry()
    local = reg.export_state()
    states = [(host_id(), local)]
    try:
        from ..parallel import dist
        if dist.is_initialized():
            blobs = dist.allgather_bytes(json.dumps(local).encode("utf-8"))
            states = [(i, json.loads(b.decode("utf-8")))
                      for i, b in enumerate(blobs)]
            _last_host_states = states
    except Exception as e:   # noqa: BLE001 — observability must never
        # kill the job it observes: degrade to the local view
        import warnings
        warnings.warn(f"multi-host metric gather failed; serving the "
                      f"local view only ({e})", RuntimeWarning,
                      stacklevel=2)
    return states


def ingest_host_states(states: List[Tuple[int, dict]]) -> None:
    """Install externally gathered per-host states as the remote view
    ``last_host_states`` (and the ``MXTPU_METRICS_AGGREGATE`` endpoint)
    serve: a peer's state is as of its last gather."""
    global _last_host_states
    _last_host_states = sorted(
        ((int(h), dict(st)) for h, st in states), key=lambda hs: hs[0])


def last_host_states(reg: Optional[MetricsRegistry] = None
                     ) -> List[Tuple[int, dict]]:
    """Per-host states for the serving path: THIS host's state is read
    live from the registry; remote hosts are as of the states last
    ingested.  Before any (or single-process) this is the local host."""
    reg = reg if reg is not None else registry()
    me = host_id()
    states = [(me, reg.export_state())]
    if _last_host_states is not None:
        states += [(h, st) for h, st in _last_host_states if h != me]
        states.sort(key=lambda hs: hs[0])
    return states


def state_bounds(state: dict) -> Tuple[float, ...]:
    """Rebuild a histogram state's bucket upper bounds from its
    ``base``/``growth`` (the overflow bucket carries no bound)."""
    n = len(state["counts"]) - 1
    base, growth = state["base"], state["growth"]
    return tuple(base * growth ** i for i in range(n))


def state_cumulative_buckets(state: dict) -> List[Tuple[float, int]]:
    """(upper_bound, cumulative_count) pairs from a raw histogram state
    — the state-dict twin of :meth:`Histogram.cumulative_buckets`, with
    the same elision of empty buckets and final (inf, count) pair."""
    bounds = state_bounds(state)
    out: List[Tuple[float, int]] = []
    acc = 0
    for i, c in enumerate(state["counts"][:-1]):
        acc += c
        if c:
            out.append((bounds[i], acc))
    out.append((float("inf"), state["count"]))
    return out


def group_host_entries(states: List[Tuple[int, dict]]):
    """Iterate the union of metric names across per-host states as
    ``(name, kind, [(host, entry), ...])``, keeping only entries whose
    kind matches the first host reporting that name (a disagreeing host
    is dropped from that series rather than corrupting it).  Shared by
    the merge and the host-labeled Prometheus text format so the two
    views can't drift."""
    names = sorted({n for _, st in states for n in st})
    for name in names:
        entries = [(h, st[name]) for h, st in states if name in st]
        kind = entries[0][1].get("kind")
        yield name, kind, [(h, e) for h, e in entries
                           if e.get("kind") == kind]


def merge_host_states(states: List[Tuple[int, dict]]) -> dict:
    """Merge per-host raw states into one host-labeled fleet snapshot:

    - counter → ``{"kind", "total", "host": {"<i>": n}}``
    - gauge → ``{"kind", "host": {"<i>": v}}`` (no cross-host sum — a
      queue depth summed over hosts is meaningless; PromQL aggregates)
    - histogram → merged aggregate (buckets added elementwise across
      hosts with identical bucketing) plus a per-host aggregate map

    A host whose metric kind or bucketing disagrees with the first
    host's is reported under its host label but left out of the merged
    totals rather than silently corrupting them."""
    merged: Dict[str, dict] = {}
    for name, kind, entries in group_host_entries(states):
        if kind == "counter":
            merged[name] = {
                "kind": "counter",
                "total": sum(e["n"] for _, e in entries),
                "host": {str(h): e["n"] for h, e in entries}}
        elif kind == "gauge":
            merged[name] = {
                "kind": "gauge",
                "host": {str(h): e["v"] for h, e in entries}}
        elif kind == "histogram":
            ref = entries[0][1]
            bounds = state_bounds(ref)
            counts = [0] * len(ref["counts"])
            count, total = 0, 0.0
            vmin, vmax = None, None
            per_host = {}
            for h, e in entries:
                per_host[str(h)] = _aggregate_from(
                    state_bounds(e), e["counts"], e["count"], e["total"],
                    e["min"], e["max"])
                if (e["base"], e["growth"], len(e["counts"])) != \
                        (ref["base"], ref["growth"], len(ref["counts"])):
                    continue     # incompatible bucketing: labeled only
                for i, c in enumerate(e["counts"]):
                    counts[i] += c
                count += e["count"]
                total += e["total"]
                if e["min"] is not None and \
                        (vmin is None or e["min"] < vmin):
                    vmin = e["min"]
                if e["max"] is not None and \
                        (vmax is None or e["max"] > vmax):
                    vmax = e["max"]
            agg = _aggregate_from(bounds, counts, count, total, vmin,
                                  vmax)
            agg["kind"] = "histogram"
            agg["host"] = per_host
            merged[name] = agg
    return merged
