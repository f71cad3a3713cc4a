"""Kernel launch counters that stay true under CUDA graphs.

Every kernel wrapper of the port counts its launches in a plain integer
(``flash_attention.launches``, ``multi_sgd.launches``, an rtc kernel's
``launches``, ...).  A wrapper adds to its count through :func:`bump`.

A CUDA-graph capture runs the wrappers, but the card executes nothing: a
call on a stream that is being captured is recorded, not counted, into
the delta of the capture under way (:func:`recording`).  Each replay of
the graph then adds that delta (:func:`replay`), so a count reads the
launches the card executed, whether they came from eager calls or from
replays.  Captures are one at a time in a process, as CUDA graphs require,
so one capture's delta is open at a time; the stream test keeps other
threads' eager launches out of it.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Tuple

import torch

__all__ = ["bump", "recording", "replay", "lock"]

lock = threading.Lock()
_delta = None            # the delta of the capture under way, or None


def _add(holder, key, n: int) -> None:
    if isinstance(holder, dict):
        holder[key] += n
    else:
        setattr(holder, key, getattr(holder, key) + n)


def bump(holder, key: str, n: int = 1) -> None:
    """Count ``n`` launches in ``holder.key`` (``holder[key]`` for a
    dict), or, on a stream being captured, in the capture's delta."""
    delta = _delta
    if delta is not None and torch.cuda.is_available() and \
            torch.cuda.is_current_stream_capturing():
        slot = (id(holder), key)
        old = delta.get(slot)
        delta[slot] = (holder, key, n + (old[2] if old else 0))
        return
    with lock:
        _add(holder, key, n)


@contextlib.contextmanager
def recording():
    """Open a capture's delta: ``{(id(holder), key): (holder, key, n)}``."""
    global _delta
    prev, _delta = _delta, {}
    try:
        yield _delta
    finally:
        _delta = prev


def replay(delta: Dict[Tuple[int, str], tuple]) -> None:
    """Add one replay's launches."""
    if not delta:
        return
    with lock:
        for holder, key, n in delta.values():
            _add(holder, key, n)
