"""Foundations: error type, env-var config registry, dtype canonicalisation.

PyTorch counterpart of ``mxnet_tpu/base.py``, cut to what the serving and
Gluon training paths read: the ``MXTPU_SERVING_*`` request- and
generation-serving knobs, the ``MXTPU_FRONTEND_*`` front-door knobs,
``MXNET_ATTENTION_KERNEL``, ``MXNET_OPTIMIZER_AGGREGATION_SIZE``, and the
observability and self-tuning knobs (``MXTPU_METRICS_*``,
``MXTPU_FLIGHT_*``, ``MXTPU_TRACE*``, ``MXTPU_PROF_*``,
``MXTPU_DEBUG_ENDPOINTS``, ``MXTPU_WATCHDOG_*``, ``MXTPU_STACKS_SIGNAL``,
``MXTPU_TUNE_*``) under the JAX package's names.
The registry is a typed view over ``os.environ``, read live on every
``get_env`` call.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Callable, Dict

import numpy as np
import torch

__all__ = ["MXNetError", "register_env", "get_env", "list_env",
           "compute_dtype",
           "torch_dtype"]


class MXNetError(RuntimeError):
    """Default error type of this framework."""


class _EnvEntry:
    __slots__ = ("name", "default", "typ", "help")

    def __init__(self, name: str, default: Any, typ: Callable, help: str):
        self.name = name
        self.default = default
        self.typ = typ
        self.help = help


_env_registry: Dict[str, _EnvEntry] = {}
_env_lock = threading.Lock()


def _parse_bool(v: Any) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).strip().lower() in ("1", "true", "yes", "on")


def register_env(name: str, default: Any, typ: Callable = str,
                 help: str = "") -> None:
    """Register an ``MXNET_*``/``MXTPU_*`` environment variable with a typed
    default (a ``bool`` knob reads "1", "true", "yes" and "on" as true)."""
    if typ is bool:
        typ = _parse_bool
    with _env_lock:
        _env_registry[name] = _EnvEntry(name, default, typ, help)


def get_env(name: str, default: Any = None) -> Any:
    """Read a registered env var, applying its type (a value that does not
    parse falls back to the default); unregistered names read raw
    ``os.environ`` with ``default``."""
    entry = _env_registry.get(name)
    raw = os.environ.get(name)
    if entry is None:
        return raw if raw is not None else default
    if raw is None:
        return entry.default
    try:
        return entry.typ(raw)
    except (TypeError, ValueError):
        return entry.default


def list_env() -> Dict[str, Any]:
    """Every registered env var with its current effective value."""
    return {k: get_env(k) for k in sorted(_env_registry)}


register_env("MXNET_ATTENTION_KERNEL", "auto", str,
             "Attention path: 'auto' (the flash-attention kernel on a "
             "CUDA tensor, its plain version on a CPU tensor) or 'xla' "
             "(the full masked-softmax path); any other value raises.")
register_env("MXNET_OPTIMIZER_AGGREGATION_SIZE", 4, int,
             "Max parameters one multi-tensor optimizer update takes "
             "(gluon.Trainer groups them; read when an SGD optimizer is "
             "created); <=1 updates each parameter on its own.")
register_env("MXTPU_SERVING_MAX_BATCH", 8, int,
             "Serving: max requests fused into one batched call; batch "
             "buckets are powers of two up to this.")
register_env("MXTPU_SERVING_QUEUE_DEPTH", 256, int,
             "Serving: admission-queue bound; submits beyond it are "
             "rejected with ServerOverloaded (the HTTP-429 analog).")
register_env("MXTPU_SERVING_DEADLINE_MS", 100.0, float,
             "Serving: default per-request deadline; requests still "
             "queued when it expires are rejected at batch assembly "
             "(429-style). 0 disables.")
register_env("MXTPU_SERVING_WORKERS", 2, int,
             "Serving: dispatch worker threads; >1 lets batch formation "
             "overlap device execution.")
register_env("MXTPU_SERVING_BATCH_WINDOW_US", 2000.0, float,
             "Serving: how long the batcher waits for the current shape "
             "bucket to fill before dispatching a partial batch. Read "
             "live per batch.")

register_env("MXTPU_SERVING_KV_BLOCK", 16, int,
             "Serving: KV-cache block size in token positions; the paging "
             "granularity of the generation scheduler's block manager "
             "(serving.kv_cache).")
register_env("MXTPU_SERVING_KV_BLOCKS", 128, int,
             "Serving: total KV-cache blocks pre-allocated per generation "
             "server (block 0 is reserved scratch, so usable capacity is "
             "one less). Admission to the running batch gates on a "
             "worst-case block reservation against this pool.")
register_env("MXTPU_SERVING_DECODE_SLOTS", 4, int,
             "Serving: running-batch slot count of the iteration-level "
             "decode scheduler: how many requests decode together in one "
             "decode step.")
register_env("MXTPU_SERVING_PREFILL_MODE", "interleave", str,
             "Serving: 'interleave' admits at most one prompt prefill per "
             "decode iteration (smooth decode cadence); 'step' prefills "
             "every admissible queued request before the next decode step "
             "(fastest drain of a burst). Read live per iteration.")
register_env("MXTPU_SERVING_MAX_NEW_TOKENS", 64, int,
             "Serving: default cap on generated tokens per request when "
             "submit_generate() is not given max_new_tokens; also bounds "
             "the worst-case KV block reservation.")
register_env("MXTPU_FRONTEND_PORT", "", str,
             "Serving: TCP port for the multi-model HTTP frontend "
             "(serving.HttpFrontend: JSON predict, SSE token streaming). "
             "Empty (default) binds an ephemeral port; the frontend only "
             "listens when constructed explicitly.")
register_env("MXTPU_FRONTEND_PRIORITY", 0, int,
             "Serving: default priority for models loaded into the "
             "ModelRegistry without an explicit one (higher = more "
             "important; models below the registry shed level are 429'd "
             "at the door).")

register_env("MXTPU_FAULT_PLAN", "", str,
             "Deterministic fault-injection schedule, e.g. "
             "'loader_stall@4:1.5;loader_error@2' (faults.py).")
register_env("MXTPU_DIST_TIMEOUT", 300.0, float,
             "Per-attempt timeout (seconds) for joining the process group "
             "and for every collective, barrier and store wait of "
             "parallel.dist (a peer that never arrives raises "
             "DeadlineExceeded).")
register_env("MXTPU_ELASTIC", False, bool,
             "Elastic process groups (host loss and re-forms): not "
             "ported; init_process_group raises when it is on.")
register_env("MXTPU_ZERO_STAGE", 0, int,
             "Default ZeRO optimizer-state partitioning stage for "
             "ShardedTrainer (0, 1 or 2): 0 = optimizer state replicated "
             "on every rank; 1 = state sharded 1/dp per rank, gradients "
             "reduce-scattered into each rank's slice and the updated "
             "parameters all-gathered; 2 = the gradient (accumulation) "
             "buffer is sharded too.  The zero_stage= argument overrides.")
register_env("MXTPU_ACCUM_STEPS", 1, int,
             "Default microbatched gradient accumulation for "
             "ShardedTrainer: the step runs its global batch as N "
             "microbatches, rescale-correct against the full batch.  The "
             "accum_steps= argument overrides.")
register_env("MXTPU_COMM_BUCKET_MB", 0.0, float,
             "Bucketed gradient reduction for ShardedTrainer: buckets of "
             "at most this many MB in reverse parameter order, each "
             "reduced as soon as backward has produced it.  0 = one "
             "reduction after the whole backward.  The comm_bucket_mb= "
             "argument overrides.")
register_env("MXTPU_DEVICE_PREFETCH", 0, int,
             "DataLoader device stage: keep up to N batches in flight on "
             "the device beyond the one being consumed, each copied from "
             "(pinned) host memory on a side CUDA stream that the "
             "consumer's stream waits on.  0 (the default) = off.  The "
             "device_prefetch= constructor argument overrides; applied "
             "at each __iter__.")

register_env("MXTPU_METRICS_PORT", "", str,
             "Serve the Prometheus /metrics endpoint on this port "
             "(unset = no HTTP server).")
register_env("MXTPU_METRICS_JSONL", "", str,
             "Append periodic registry snapshots to this JSONL path "
             "(unset = no writer).")
register_env("MXTPU_METRICS_INTERVAL", 60.0, float,
             "Seconds between JSONL metric snapshots.")
register_env("MXTPU_METRICS_AGGREGATE", False, bool,
             "Serve the fleet (all-hosts) view from /metrics, every "
             "series host-labeled: the states of the last "
             "snapshot(all_hosts=True) or fleet gather.")
register_env("MXTPU_FLIGHT_STEPS", 256, int,
             "Crash flight-recorder ring capacity (0 disables).")
register_env("MXTPU_FLIGHT_PATH", "", str,
             "Crash flight-recorder dump file "
             "(default <tmpdir>/mxtpu_flight_<pid>.json).")
register_env("MXTPU_FRONTEND_SLO_MS", 0.0, float,
             "Serving: default per-model p99 latency SLO in ms for models "
             "loaded without an explicit slo_ms, the budget the "
             "SloController defends (0 = no SLO, never watched).")
register_env("MXTPU_TUNE_SLO", True, bool,
             "Self-tuning: enable the SloController (sheds the lowest "
             "priority first and scales the violator's dispatch workers "
             "when a model's socket-to-socket p99 exceeds its SLO).")
register_env("MXTPU_TUNE_DECODE_SLOTS", False, bool,
             "Self-tuning: enable the DecodeSlotController (hill-climbs "
             "a GenerationServer's decode slots on interval tokens/s).  "
             "Off by default: attach it to a server explicitly.")
register_env("MXTPU_TUNE_FLEET_GATHER", True, bool,
             "Self-tuning: enable the FleetGatherController (the "
             "multi-host metric gather over the process group's store, "
             "barrier-free, on the timer thread) in an initialized "
             "process group.")
register_env("MXTPU_TUNE_INTERVAL", 2.0, float,
             "Self-tuning: seconds between the controller timer thread's "
             "ticks.")
register_env("MXTPU_TUNE_DRY_RUN", False, bool,
             "Self-tuning: compute and record every controller decision "
             "(tuning.* metrics and flight records) but apply nothing.")
register_env("MXTPU_TUNE_PREFETCH", True, bool,
             "Self-tuning: enable the PrefetchController (the DataLoader "
             "prefetch depth from the loader.prefetch_depth gauge).")
register_env("MXTPU_TUNE_BATCH_WINDOW", True, bool,
             "Self-tuning: enable the BatchWindowController "
             "(MXTPU_SERVING_BATCH_WINDOW_US from serving.queue_depth and "
             "the serving.request_us p99).")
register_env("MXTPU_TUNE_DEVICE_PREFETCH", True, bool,
             "Self-tuning: enable the DevicePrefetchController (the "
             "DataLoader device-prefetch depth from the "
             "loader.device_put_us tail).")
register_env("MXTPU_TRACE", False, bool,
             "Causal tracing: record request span trees with W3C trace "
             "and span ids (observability.tracing) and attach trace-id "
             "exemplars to every histogram bucket.  Off (the default): "
             "the instrumented paths pay one memoized env probe.")
register_env("MXTPU_TRACE_SAMPLE", 1, int,
             "Causal tracing head sampling: start a new root trace for 1 "
             "in N decisions (children of a sampled trace are always "
             "recorded).")
register_env("MXTPU_TRACE_RING", 2048, int,
             "Causal tracing: capacity of the in-memory ring of completed "
             "spans.")
register_env("MXTPU_TRACE_JSONL", "", str,
             "Causal tracing: append completed spans to this JSONL path "
             "(size-rotated, ~64 spans a write).  Unset disables the "
             "stream.")
register_env("MXTPU_PROF_SAMPLE_HZ", 0.0, float,
             "Stack-sampling profiler: walk every thread's frames this "
             "many times a second into collapsed-stack counts in rotating "
             "windows.  0 (the default) = off.")
register_env("MXTPU_PROF_WINDOW_SECS", 60.0, float,
             "Stack sampler: seconds of samples a profile window holds "
             "before it rotates into the ring.")
register_env("MXTPU_PROF_WINDOWS", 8, int,
             "Stack sampler: how many rotated profile windows to keep.")
register_env("MXTPU_DEBUG_ENDPOINTS", False, bool,
             "Serve /debug/stacks, /debug/profile, /debug/flight, "
             "/debug/trace/<id> and /debug/vars from the HttpFrontend and "
             "the MXTPU_METRICS_PORT exporter.  Off (the default) = those "
             "paths 404; they need no auth, so enable them only on "
             "trusted networks.")
register_env("MXTPU_WATCHDOG_FACTOR", 0.0, float,
             "Progress watchdog: flag a heartbeat touchpoint (the serving "
             "dispatch workers, the decode loop) silent for FACTOR x its "
             "recent p99 interval, then write one postmortem.  0 (the "
             "default) = off.")
register_env("MXTPU_WATCHDOG_ACTION", "dump", str,
             "Progress watchdog action on a stall: 'dump' (write the "
             "postmortem, keep running) or 'term' (dump, then SIGTERM "
             "the process).")
register_env("MXTPU_STACKS_SIGNAL", "SIGQUIT", str,
             "Signal that dumps all-thread stacks and the flight rings "
             "next to the flight path without killing the process; empty "
             "disables it.")


def compute_dtype(dtype: Any) -> np.dtype:
    """The dtype a request input is served in: 64-bit ints and floats map
    to their 32-bit duals (int64 -> int32, uint64 -> uint32,
    float64 -> float32), as the JAX package's default 32-bit mode stores
    them, so equal requests key the same shape bucket."""
    d = np.dtype(dtype)
    if d.itemsize == 8 and d.kind in "iuf":
        return np.dtype({"i": np.int32, "u": np.uint32,
                         "f": np.float32}[d.kind])
    return d


def torch_dtype(dtype: Any) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or type, or a name
    (``"float32"``)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise MXNetError(f"unknown dtype {dtype!r}")
    return dt
