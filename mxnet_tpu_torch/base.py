"""Foundations: error type, env-var config registry, dtype canonicalisation.

PyTorch counterpart of ``mxnet_tpu/base.py``, cut to what the serving and
Gluon training paths read: the ``MXTPU_SERVING_*`` request- and
generation-serving knobs, the ``MXTPU_FRONTEND_*`` front-door knobs,
``MXNET_ATTENTION_KERNEL`` and ``MXNET_OPTIMIZER_AGGREGATION_SIZE``.
The registry is a typed view over ``os.environ``, read live on every
``get_env`` call.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Callable, Dict

import numpy as np
import torch

__all__ = ["MXNetError", "register_env", "get_env", "compute_dtype",
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


def register_env(name: str, default: Any, typ: Callable = str,
                 help: str = "") -> None:
    """Register an ``MXNET_*``/``MXTPU_*`` environment variable with a typed
    default."""
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
