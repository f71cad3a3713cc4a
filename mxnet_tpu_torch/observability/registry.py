"""Process-global metrics registry: Counter / Gauge / Histogram.

Counterpart of ``mxnet_tpu/observability/registry.py``, cut to what
``ModelServer`` records: get-or-create metrics under namespaced dotted
names, lock-exact counter increments, and fixed log-scale histograms
(``bounds[i] = base * growth**i``, 10 buckets per decade by default) whose
percentiles resolve to one bucket, and ``snapshot()``, every metric in
one dict.  Exemplars, exporters and the multi-host merge are not ported.
"""
from __future__ import annotations

import re
import threading
from bisect import bisect_left
from typing import Dict, List, Optional, Tuple, Union

from ..base import MXNetError

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "registry"]

_NAME_RE = re.compile(r"^[a-z_][a-z0-9_]*(\.[a-z0-9_]+)+$")


class Counter:
    """Monotonic event count; ``inc()`` is exact under threads."""

    __slots__ = ("name", "n", "help", "_lock")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.n = 0
        self.help = help
        self._lock = threading.Lock()

    def inc(self, amount: int = 1) -> None:
        with self._lock:
            self.n += amount

    def read(self) -> int:
        return self.n


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "_v", "help")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self._v = 0.0
        self.help = help

    def set(self, value: float) -> None:
        self._v = float(value)

    @property
    def value(self) -> float:
        return self._v

    def read(self) -> float:
        return self._v


class Histogram:
    """Fixed log-scale-bucket histogram: ``counts[i]`` counts observations
    in ``(bounds[i-1], bounds[i]]``; ``counts[-1]`` is the overflow."""

    __slots__ = ("name", "bounds", "counts", "count", "total", "vmin",
                 "vmax", "help", "_lock")

    def __init__(self, name: str, base: float = 1.0,
                 growth: float = 10.0 ** 0.1, buckets: int = 120,
                 help: str = ""):
        if base <= 0 or growth <= 1.0 or buckets < 1:
            raise MXNetError(
                f"Histogram {name!r}: need base > 0, growth > 1, "
                f"buckets >= 1 (got {base}, {growth}, {buckets})")
        self.name = name
        self.bounds: Tuple[float, ...] = tuple(
            base * growth ** i for i in range(buckets))
        self.counts: List[int] = [0] * (buckets + 1)
        self.count = 0
        self.total = 0.0
        self.vmin: Optional[float] = None
        self.vmax: Optional[float] = None
        self.help = help
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        i = bisect_left(self.bounds, value)
        with self._lock:
            self.counts[i] += 1
            self.count += 1
            self.total += value
            if self.vmin is None or value < self.vmin:
                self.vmin = value
            if self.vmax is None or value > self.vmax:
                self.vmax = value

    def percentile(self, q: float) -> float:
        """Approximate q-th percentile (q in [0, 100]): the containing
        bucket's upper bound, clamped to the observed min/max."""
        with self._lock:
            if not self.count:
                return 0.0
            rank = max(1, int(round(q / 100.0 * self.count)))
            acc = 0
            for i, c in enumerate(self.counts):
                acc += c
                if acc >= rank:
                    if i >= len(self.bounds):
                        return float(self.vmax)
                    return float(min(max(self.bounds[i], self.vmin),
                                     self.vmax))
            return float(self.vmax)

    def read(self) -> dict:
        """The aggregate view ``snapshot()`` gives a histogram."""
        return {"count": self.count, "sum": self.total,
                "min": self.vmin, "max": self.vmax,
                "p50": self.percentile(50), "p99": self.percentile(99)}


_Metric = Union[Counter, Gauge, Histogram]


class MetricsRegistry:
    """Thread-safe name -> metric map; ``counter``/``gauge``/``histogram``
    get-or-create, and asking for an existing name with another type
    raises."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, name: str, cls, **kwargs) -> _Metric:
        if not _NAME_RE.match(name):
            raise MXNetError(
                f"bad metric name {name!r}: use namespaced lowercase "
                f"dotted names like 'serving.requests'")
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

    def snapshot(self) -> dict:
        """Every metric in one dict: counters as ints, gauges as floats,
        histograms as ``Histogram.read()``'s aggregate."""
        with self._lock:
            items = sorted(self._metrics.items())
        return {name: m.read() for name, m in items}


_registry_lock = threading.Lock()
_registry_inst: Optional[MetricsRegistry] = None


def registry() -> MetricsRegistry:
    """The process-global registry."""
    global _registry_inst
    with _registry_lock:
        if _registry_inst is None:
            _registry_inst = MetricsRegistry()
        return _registry_inst
