"""Fault handling for the data pipeline: bounded retry and deterministic
fault injection.

The port's own copy of what the ``DataLoader`` uses from
``mxnet_tpu/faults.py`` (:66-295): ``TransientFault``, ``retry_call``
(exponential backoff with jitter), and
``FaultPlan``/``active_plan``/``set_fault_plan`` with the
``MXTPU_FAULT_PLAN`` knob.  Deadlines and the supervisor's host-level
kinds are not ported.

Fault-plan grammar (``MXTPU_FAULT_PLAN`` or :class:`FaultPlan`):

    plan  := entry (';' entry)*
    entry := kind '@' index ['x' count] [':' arg]

``kind`` names an instrumented site (the loader's are ``loader_stall``,
which sleeps ``arg`` seconds, 30 without one, before building batch
``index``, and ``loader_error``, which raises :class:`TransientFault` on
the first attempt at batch ``index``); ``index`` is 1-based, ``xN``
repeats the entry for N consecutive indices.  Each entry fires once and
is then consumed, so a retried attempt succeeds.
"""
from __future__ import annotations

import random as _pyrandom
import re
import threading
import time
from typing import Callable, List, NamedTuple, Optional, Tuple, Type

from .base import MXNetError, get_env

__all__ = ["TransientFault", "retry_call", "FaultSpec", "FaultPlan",
           "active_plan", "set_fault_plan"]

FAULT_PLAN_ENV = "MXTPU_FAULT_PLAN"


class TransientFault(MXNetError):
    """A failure that is expected to succeed on retry (injected faults,
    flaky I/O)."""


def _retry_counter():
    from .observability.registry import registry
    return registry().counter("faults.retries")


def retry_call(fn: Callable, *args,
               retries: int = 3,
               base_delay: float = 0.05,
               max_delay: float = 2.0,
               jitter: float = 0.25,
               retry_on: Tuple[Type[BaseException], ...] = (TransientFault,),
               on_retry: Optional[Callable] = None,
               sleep: Callable[[float], None] = time.sleep,
               **kwargs):
    """Call ``fn(*args, **kwargs)``, retrying ``retry_on`` failures with
    exponential backoff (``base_delay * 2**attempt``, capped at
    ``max_delay``) plus up to ``jitter`` fractional random spread.

    ``on_retry(attempt, exc, delay)`` runs before each sleep.  The last
    failure re-raises.
    """
    if retries < 0:
        raise MXNetError(f"retry_call: retries must be >= 0, got {retries}")
    attempt = 0
    while True:
        try:
            return fn(*args, **kwargs)
        except retry_on as exc:
            attempt += 1
            if attempt > retries:
                raise
            _retry_counter().inc()
            delay = min(max_delay, base_delay * (2.0 ** (attempt - 1)))
            if jitter:
                delay *= 1.0 + jitter * _pyrandom.random()
            if on_retry is not None:
                on_retry(attempt, exc, delay)
            sleep(delay)


class FaultSpec(NamedTuple):
    kind: str
    index: int
    arg: Optional[float]


_ENTRY_RE = re.compile(
    r"^(?P<kind>[a-z][a-z0-9_]*)@(?P<idx>\d+)"
    r"(?:x(?P<count>\d+))?(?::(?P<arg>[-+0-9.eE]+))?$")


class FaultPlan:
    """A deterministic schedule of injected faults.  Sites call
    :meth:`scheduled(kind, index)` with their 1-based counter; a matching
    entry is consumed and returned.  Thread-safe: loader workers consult
    it from their threads."""

    def __init__(self, spec: str = ""):
        self._lock = threading.Lock()
        self._entries: List[FaultSpec] = []
        for raw in re.split(r"[;,]", (spec or "").strip()):
            raw = raw.strip()
            if not raw:
                continue
            m = _ENTRY_RE.match(raw)
            if not m:
                raise MXNetError(
                    f"bad {FAULT_PLAN_ENV} entry {raw!r}: expected "
                    f"'kind@index[xcount][:arg]' "
                    f"(e.g. 'loader_error@3', 'loader_stall@4:1.5')")
            idx = int(m.group("idx"))
            arg = float(m.group("arg")) if m.group("arg") is not None \
                else None
            for k in range(int(m.group("count") or 1)):
                self._entries.append(FaultSpec(m.group("kind"), idx + k,
                                               arg))

    @property
    def empty(self) -> bool:
        with self._lock:
            return not self._entries

    def pending(self) -> List[FaultSpec]:
        """Entries not yet fired."""
        with self._lock:
            return list(self._entries)

    def scheduled(self, kind: str, index: int) -> Optional[FaultSpec]:
        """Consume and return the fault scheduled for (kind, index), if
        any; several entries at one site fire one per call."""
        with self._lock:
            for i, e in enumerate(self._entries):
                if e.kind == kind and e.index == index:
                    return self._entries.pop(i)
            return None

    def fire(self, kind: str, index: int) -> None:
        """Raise :class:`TransientFault` when a fault is due at
        (kind, index)."""
        if self.scheduled(kind, index) is not None:
            raise TransientFault(
                f"injected fault {kind}@{index} (MXTPU_FAULT_PLAN)")

    def __repr__(self) -> str:
        with self._lock:
            return f"FaultPlan({self._entries!r})"


_active_lock = threading.Lock()
_active: Optional[FaultPlan] = None
_active_loaded = False


def active_plan() -> Optional[FaultPlan]:
    """The process-global plan: set by :func:`set_fault_plan`, else
    parsed once from ``MXTPU_FAULT_PLAN``, else ``None``."""
    global _active, _active_loaded
    with _active_lock:
        if not _active_loaded:
            _active_loaded = True
            spec = get_env(FAULT_PLAN_ENV).strip()
            if spec:
                _active = FaultPlan(spec)
        return _active


def set_fault_plan(plan) -> None:
    """Install (or clear, with ``None``) the process-global fault plan:
    a :class:`FaultPlan` or a grammar string."""
    global _active, _active_loaded
    if isinstance(plan, str):
        plan = FaultPlan(plan)
    if plan is not None and not isinstance(plan, FaultPlan):
        raise MXNetError(f"set_fault_plan: expected FaultPlan, str or None, "
                         f"got {type(plan).__name__}")
    with _active_lock:
        _active = plan
        _active_loaded = True
