"""Crash flight recorder: the last N records of a run, and a full
snapshot, dumped to JSON when it dies.

Counterpart of ``mxnet_tpu/observability/flight.py``.  When a job
crashes its metrics die with it; the flight recorder keeps bounded rings
of recent records and writes them with a complete
``registry().snapshot()`` and the tracer's span ring to one JSON file.
Four rings, the JAX package's:

- **steps** (``record``): per-step records of a training loop;
- **requests** (``record_request``): one record per served request
  (``request_id``, enqueue/assemble/dispatch/done timestamps, shape
  bucket, batch size, trace id), fed by ``ModelServer`` and
  ``GenerationServer`` at completion;
- **tuning** (``record_tuning``): one record per ``tuning`` controller
  decision;
- **membership** (``record_membership``): fleet membership events.  The
  port's recorder holds the ring; its producers (the resilience and
  membership layers) wait for the port of the ``parallel`` layer.

Dump triggers: an unhandled exception (``install()`` chains
``sys.excepthook``), or ``recorder().dump("why")`` from any shutdown
path.

Cost discipline: a record is a dict build and a deque append: no
formatting, no I/O and no device sync.  A record may hold a CUDA tensor
(a step's loss): it is kept as a reference and turned into a host value
(``.item()``/``.tolist()``) only in :meth:`FlightRecorder.dump` and
:meth:`FlightRecorder.live`, best-effort (a device that refuses the read
gives ``None``, never blocks the dump).

Env knobs: ``MXTPU_FLIGHT_STEPS`` (ring capacity, default 256; 0
disables recording and dumping) and ``MXTPU_FLIGHT_PATH`` (dump file,
default ``<tmpdir>/mxtpu_flight_<pid>.json``; the dump also carries its
``host`` index).
"""
from __future__ import annotations

import collections
import json
import os
import sys
import tempfile
import threading
import time
from typing import Deque, List, Optional

from ..base import get_env
from .registry import host_id, registry

__all__ = ["FlightRecorder", "recorder", "write_json_atomic",
           "FLIGHT_STEPS_ENV", "FLIGHT_PATH_ENV"]

FLIGHT_STEPS_ENV = "MXTPU_FLIGHT_STEPS"
FLIGHT_PATH_ENV = "MXTPU_FLIGHT_PATH"


def _env_capacity() -> int:
    # the registered default (256) covers unset AND unparsable values
    return max(0, int(get_env(FLIGHT_STEPS_ENV)))


def _materialize(v):
    """Best-effort JSON-friendly conversion at dump time.  Device values
    (a torch tensor, an NDArray) are read to the host HERE, never at
    record time; a device too broken to read them yields None instead of
    blocking the dump."""
    if v is None or isinstance(v, (bool, int, str)):
        return v
    if isinstance(v, (list, tuple)):
        # membership records carry member lists and (phase, ts)
        # timelines: recurse instead of degrading them to None
        return [_materialize(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _materialize(x) for k, x in v.items()}
    try:
        t = getattr(v, "_data", v)        # an NDArray's torch tensor
        if hasattr(t, "detach"):
            t = t.detach()
            return t.item() if t.numel() == 1 else t.tolist()
        if hasattr(v, "asnumpy"):
            return float(v.asnumpy())
        return float(v)
    except Exception:   # noqa: BLE001 — a crashed device must not
        return None     # take the dump down with it


def write_json_atomic(payload: dict, path: str) -> Optional[str]:
    """Atomic JSON write (tmp-then-rename), never raises: the shared
    dump primitive for crash dumps, watchdog postmortems, and signal
    stack dumps — all of which run on processes in trouble.  Returns
    the path, or None when the write failed."""
    try:
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)
        return path
    except (OSError, TypeError, ValueError):
        return None


class FlightRecorder:
    """Bounded ring of per-step records with crash-time JSON dump.

    ``capacity=None`` / ``path=None`` defer to the env knobs (capacity
    is resolved at construction, the path at each dump — so a test can
    redirect dumps without rebuilding the recorder).
    """

    def __init__(self, capacity: Optional[int] = None,
                 path: Optional[str] = None):
        self.capacity = _env_capacity() if capacity is None \
            else max(0, int(capacity))
        self.path = path
        self._ring: Deque[dict] = collections.deque(
            maxlen=max(1, self.capacity))
        self._req_ring: Deque[dict] = collections.deque(
            maxlen=max(1, self.capacity))
        self._tune_ring: Deque[dict] = collections.deque(
            maxlen=max(1, self.capacity))
        self._member_ring: Deque[dict] = collections.deque(
            maxlen=max(1, self.capacity))
        self._lock = threading.Lock()
        self._installed = False
        self._prev_hook = None

    @property
    def enabled(self) -> bool:
        return self.capacity > 0

    def record(self, **fields) -> None:
        """Append one step record.  Cheap: no I/O, no sync — device
        values may be passed as-is and are materialized at dump time."""
        if not self.enabled:
            return
        with self._lock:
            self._ring.append(fields)

    def record_request(self, **fields) -> None:
        """Append one served-request record to the request ring (same
        cost discipline as :meth:`record` — a dict build and a deque
        append, no I/O, no sync)."""
        if not self.enabled:
            return
        with self._lock:
            self._req_ring.append(fields)

    def record_tuning(self, **fields) -> None:
        """Append one controller-decision record to the tuning ring
        (same cost discipline: dict build + deque append)."""
        if not self.enabled:
            return
        with self._lock:
            self._tune_ring.append(fields)

    def record_membership(self, **fields) -> None:
        """Append one fleet-membership event (lease suspicion, fencing,
        committed re-form with its timeline) to the membership ring
        (same cost discipline: dict build + deque append)."""
        if not self.enabled:
            return
        with self._lock:
            self._member_ring.append(fields)

    def records(self) -> List[dict]:
        with self._lock:
            return list(self._ring)

    def requests(self) -> List[dict]:
        with self._lock:
            return list(self._req_ring)

    def tunings(self) -> List[dict]:
        with self._lock:
            return list(self._tune_ring)

    def memberships(self) -> List[dict]:
        with self._lock:
            return list(self._member_ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._req_ring.clear()
            self._tune_ring.clear()
            self._member_ring.clear()

    def _resolve_path(self, path: Optional[str]) -> str:
        if path:
            return path
        if self.path:
            return self.path
        env = get_env(FLIGHT_PATH_ENV).strip()
        if env:
            return env
        return os.path.join(tempfile.gettempdir(),
                            f"mxtpu_flight_{os.getpid()}.json")

    def sibling_path(self, suffix: str) -> str:
        """A dump-adjacent path for companion bundles (watchdog
        postmortems, signal stack dumps): the resolved flight path with
        ``suffix`` spliced in before the extension."""
        path = self._resolve_path(None)
        root, ext = os.path.splitext(path)
        return f"{root}.{suffix}{ext or '.json'}"

    def _snapshot_rings(self) -> tuple:
        """Ring contents as plain lists, under the lock and NOTHING
        else: materialization reads device values to the host
        and must never run while writers are blocked on the lock."""
        with self._lock:
            return (list(self._ring), list(self._req_ring),
                    list(self._tune_ring), list(self._member_ring))

    def live(self) -> dict:
        """Materialized view of all four rings for live introspection
        (``/debug/flight``, watchdog postmortems) — snapshot under the
        lock, encode outside it, same shape as the dump payload's ring
        sections."""
        raw_steps, raw_reqs, raw_tune, raw_member = self._snapshot_rings()
        steps = [{k: _materialize(v) for k, v in rec.items()}
                 for rec in raw_steps]
        requests = [{k: _materialize(v) for k, v in rec.items()}
                    for rec in raw_reqs]
        tunings = [{k: _materialize(v) for k, v in rec.items()}
                   for rec in raw_tune]
        memberships = [{k: _materialize(v) for k, v in rec.items()}
                       for rec in raw_member]
        return {"n_steps": len(steps), "steps": steps,
                "n_requests": len(requests), "requests": requests,
                "n_tuning": len(tunings), "tuning": tunings,
                "n_membership": len(memberships),
                "membership": memberships}

    def dump(self, reason: str, path: Optional[str] = None
             ) -> Optional[str]:
        """Write the rings + a full registry snapshot to JSON (atomic
        tmp-then-rename); returns the path, or None when disabled or the
        write itself failed — a dump runs on dying processes and must
        never raise.  Device values are read to the host here."""
        if not self.enabled:
            return None
        path = self._resolve_path(path)
        # snapshot-then-encode: the lock protects only the list() copies;
        # _materialize may sync device values and JSON encoding is O(ring)
        # — holding the ring lock across either would stall every
        # concurrent record() (serving dispatch, trainer steps)
        raw_steps, raw_reqs, raw_tune, raw_member = self._snapshot_rings()
        steps = [{k: _materialize(v) for k, v in rec.items()}
                 for rec in raw_steps]
        requests = [{k: _materialize(v) for k, v in rec.items()}
                    for rec in raw_reqs]
        tunings = [{k: _materialize(v) for k, v in rec.items()}
                   for rec in raw_tune]
        memberships = [{k: _materialize(v) for k, v in rec.items()}
                       for rec in raw_member]
        try:
            snapshot = registry().snapshot()
        except Exception:   # noqa: BLE001 — a half-torn registry still
            snapshot = {}   # leaves the step ring worth dumping
        # causal cross-reference: step/request records carry trace_id
        # fields — ship the tracer's completed-span ring alongside so a
        # crash dump resolves those ids without hunting for the JSONL
        # stream.  Best-effort; an empty ring costs one key.
        trace_spans: List[dict] = []
        try:
            from . import tracing as _tracing
            trace_spans = _tracing.tracer().spans()
        except Exception:   # noqa: BLE001 — tracing must never block
            pass            # the dump
        payload = {
            "reason": reason,
            "ts": round(time.time(), 3),
            "host": host_id(),
            "pid": os.getpid(),
            "capacity": self.capacity,
            "n_steps": len(steps),
            "steps": steps,
            "n_requests": len(requests),
            "requests": requests,
            "n_tuning": len(tunings),
            "tuning": tunings,
            "n_membership": len(memberships),
            "membership": memberships,
            "n_trace_spans": len(trace_spans),
            "trace_spans": trace_spans,
            "snapshot": snapshot,
        }
        if write_json_atomic(payload, path) is None:
            return None
        try:
            registry().counter(
                "flight.dumps",
                help="flight-recorder dumps written").inc()
            print(f"mxnet_tpu_torch flight recorder: wrote {len(steps)} "
                  f"step record(s) to {path} ({reason})", file=sys.stderr)
        except Exception:   # noqa: BLE001 — bookkeeping only
            pass
        return path

    # -- crash hook --------------------------------------------------------
    def install(self) -> None:
        """Chain ``sys.excepthook`` so any unhandled exception dumps the
        ring before the traceback prints.  Idempotent; the previous hook
        always runs."""
        if self._installed or not self.enabled:
            return
        self._installed = True
        self._prev_hook = prev = sys.excepthook

        def hook(etype, value, tb):
            try:
                self.dump(f"unhandled {etype.__name__}: {value}")
            except Exception:   # noqa: BLE001 — never mask the real crash
                pass
            prev(etype, value, tb)

        sys.excepthook = hook

    def uninstall(self) -> None:
        if self._installed and self._prev_hook is not None:
            sys.excepthook = self._prev_hook
            self._installed = False
            self._prev_hook = None


_recorder_lock = threading.Lock()
_recorder_inst: Optional[FlightRecorder] = None


def recorder() -> FlightRecorder:
    """THE process-global flight recorder (capacity from the env)."""
    global _recorder_inst
    inst = _recorder_inst
    if inst is not None:
        return inst
    with _recorder_lock:
        if _recorder_inst is None:
            _recorder_inst = FlightRecorder()
        return _recorder_inst
