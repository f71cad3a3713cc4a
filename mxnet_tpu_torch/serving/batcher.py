"""Admission queue + continuous-batching pump for the serving subsystem.

Counterpart of ``mxnet_tpu/serving/batcher.py``.  The request path::

    client -> submit() -> AdmissionQueue -> [batcher thread] -> _Batch
           -> dispatch queue -> [worker threads] -> one CachedGraph call
           -> split rows -> Request.result()

- **backpressure**: the admission queue is depth-bounded; a submit past
  the bound fails at once with :class:`ServerOverloaded` (the HTTP-429
  analog);
- **deadlines**: a request still queued when its deadline expires is
  rejected at batch assembly with :class:`DeadlineExceeded`;
- **continuous batching**: one batcher thread drains the queue
  head-of-line by shape bucket, waits up to a short window for the bucket
  to fill, and hands assembled batches to a bounded dispatch queue that N
  workers drain, so the next batch forms while the current one runs.

:class:`GenRequest` is the generation scheduler's request
(``GenerationServer``): greedy tokens out, one a decode step, consumed
whole (``result``) or as they come (``stream``, the SSE seam).
"""
from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional, Tuple

from ..base import MXNetError
from ..observability import tracing as _tracing

__all__ = ["Request", "GenRequest", "AdmissionQueue", "Batcher",
           "ServingError", "ServerClosed", "ServerOverloaded",
           "DeadlineExceeded", "RequestCancelled"]


class ServingError(MXNetError):
    """Base class for serving-path request failures."""


class ServerClosed(ServingError):
    """Submit after shutdown (or a request shed by a non-draining stop)."""


class ServerOverloaded(ServingError):
    """Admission queue full: the 429. Retry later, ideally with backoff."""


class DeadlineExceeded(ServingError):
    """The request's deadline expired while it was still queued."""


class RequestCancelled(ServingError):
    """The client walked away (stream disconnect, explicit cancel); the
    server dropped the request at the next iteration boundary and
    released its resources."""


class Request:
    """One in-flight inference request: inputs, lifecycle timestamps (the
    flight-recorder record), and a one-shot completion event.

    ``trace`` is the request's causal-tracing root span (None when tracing
    is off or head sampling dropped it): opened at submit, finished at
    completion, and the parent every batch the request rides links back
    to.  A contextvar cannot cross the submit -> batcher -> worker thread
    hops, so the request object is the context carrier on this path."""

    __slots__ = ("rid", "inputs", "key", "deadline", "batch_size",
                 "t_enqueue", "t_assemble", "t_dispatch", "t_done",
                 "trace", "_event", "_result", "_error")

    def __init__(self, rid: int, inputs: Tuple, key: Tuple,
                 deadline: Optional[float]):
        self.rid = rid
        self.inputs = inputs
        self.key = key
        self.deadline = deadline        # monotonic seconds, None = none
        self.batch_size = 0
        self.t_enqueue = time.monotonic()
        self.t_assemble = 0.0
        self.t_dispatch = 0.0
        self.t_done = 0.0
        self.trace = None
        self._event = threading.Event()
        self._result = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        """Block until the request completes; returns the output array
        (tuple of arrays for multi-output models) or raises the request's
        error."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request {self.rid} not completed within {timeout}s")
        if self._error is not None:
            raise self._error
        return self._result


class GenRequest:
    """One in-flight generation request for the iteration-level decode
    scheduler: prompt in, greedy token ids out, one token a decode step.

    ``t_first`` is stamped when the prefill's logits yield token one (the
    ``serving.ttft_us`` histogram), ``t_done`` when the request leaves the
    running batch.  Tokens are published by :meth:`push_token`
    (scheduler side) and consumed whole (:meth:`result`) or as they come
    (:meth:`stream`).  The publisher never blocks: the token list grows
    under a condition the consumer waits on, so a slow reader stalls only
    its own socket, never the decode loop.  ``trace`` is the causal-tracing
    root opened at submit (None when tracing is off or sampled out): the
    request carries it across the submit -> scheduler hop, and every
    decode step the request rides links back to it."""

    __slots__ = ("rid", "prompt", "max_new_tokens", "deadline", "eos",
                 "tokens", "trace", "t_enqueue", "t_prefill", "t_first",
                 "t_done", "pos", "cancelled", "_tcond", "_event",
                 "_error")

    def __init__(self, rid: int, prompt, max_new_tokens: int,
                 deadline: Optional[float], eos: Optional[int]):
        self.rid = rid
        self.prompt = prompt                # 1-D int32 numpy token ids
        self.max_new_tokens = max_new_tokens
        self.deadline = deadline            # monotonic seconds, None = none
        self.eos = eos                      # stop token id, None = run to cap
        self.tokens: List[int] = []         # generated ids (EOS included)
        self.trace = None
        self.t_enqueue = time.monotonic()
        self.t_prefill = 0.0
        self.t_first = 0.0
        self.t_done = 0.0
        self.pos = 0            # position of the next token to decode
        self.cancelled = False  # set by cancel(); honoured by the
        #                         scheduler at the next iteration edge
        self._tcond = threading.Condition()
        self._event = threading.Event()
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._event.is_set()

    def push_token(self, tok: int) -> None:
        """Scheduler side: publish one generated token and wake any stream
        consumer."""
        with self._tcond:
            self.tokens.append(tok)
            self._tcond.notify_all()

    def _wake_stream(self) -> None:
        """Completion side: wake stream consumers blocked past the last
        token (called after the done event is set)."""
        with self._tcond:
            self._tcond.notify_all()

    def stream(self, timeout: Optional[float] = None):
        """Yield token ids as the scheduler emits them, ending when the
        generation finishes.  ``timeout`` bounds each wait for the next
        token, not the whole generation.  The request's error (deadline,
        shed, cancel) is raised after every token already emitted has
        been yielded."""
        i = 0
        while True:
            with self._tcond:
                while i >= len(self.tokens) and not self._event.is_set():
                    if not self._tcond.wait(timeout):
                        raise TimeoutError(
                            f"generation {self.rid}: no token within "
                            f"{timeout}s")
                fresh = self.tokens[i:]
                finished = self._event.is_set()
            for tok in fresh:
                i += 1
                yield tok
            if finished and i >= len(self.tokens):
                if self._error is not None:
                    raise self._error
                return

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Block until generation finishes; returns the generated token
        ids (EOS included when hit) or raises the request's error."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"generation {self.rid} not completed within {timeout}s")
        if self._error is not None:
            raise self._error
        return self.tokens


class AdmissionQueue:
    """Bounded FIFO with shape-bucket-aware batch pops.

    ``submit`` is the backpressure point (raises past ``depth``);
    ``pop_bucket`` takes the head request's bucket and collects up to
    ``max_batch`` peers, waiting at most ``window_s`` for it to fill.
    Expired requests are swept out and returned separately.
    """

    def __init__(self, depth: int, gauge=None):
        self.depth = int(depth)
        self._q: List[Request] = []
        self._cond = threading.Condition()
        self._closed = False
        self._gauge = gauge

    def __len__(self) -> int:
        return len(self._q)

    @property
    def closed(self) -> bool:
        return self._closed

    def _set_gauge_locked(self) -> None:
        if self._gauge is not None:
            self._gauge.set(len(self._q))

    def submit(self, req: Request) -> None:
        with self._cond:
            if self._closed:
                raise ServerClosed("server is shut down")
            if len(self._q) >= self.depth:
                raise ServerOverloaded(
                    f"admission queue full ({self.depth} deep) — "
                    f"retry with backoff (429)")
            self._q.append(req)
            self._set_gauge_locked()
            self._cond.notify_all()

    def close(self) -> None:
        """No further submits; pending requests stay for draining."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def shed(self) -> List[Request]:
        """Drop every queued request (non-draining stop); returns them so
        the caller can fail them with ServerClosed."""
        with self._cond:
            dropped, self._q = self._q, []
            self._set_gauge_locked()
            self._cond.notify_all()
            return dropped

    def pop_bucket(self, max_batch: int, window_s: float
                   ) -> Optional[Tuple[List[Request], List[Request]]]:
        """Next batch worth of requests: ``(batch, expired)``, or ``None``
        when the queue is closed and fully drained."""
        with self._cond:
            while True:
                now = time.monotonic()
                expired = [r for r in self._q
                           if r.deadline is not None and r.deadline < now]
                if expired:
                    self._q = [r for r in self._q if r not in expired]
                    self._set_gauge_locked()
                if self._q:
                    break
                if expired:
                    # deliver the expirations now: waiting for fresh
                    # traffic would strand their waiters
                    return [], expired
                if self._closed:
                    return None
                self._cond.wait()
            head_key = self._q[0].key
            t_limit = None
            while True:
                take = [r for r in self._q if r.key == head_key]
                if len(take) >= max_batch or self._closed or window_s <= 0:
                    break
                now = time.monotonic()
                if t_limit is None:
                    t_limit = now + window_s
                remaining = t_limit - now
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
            take = take[:max_batch]
            taken = set(id(r) for r in take)
            self._q = [r for r in self._q if id(r) not in taken]
            self._set_gauge_locked()
            return take, expired


class _Batch:
    """One assembled, padded batch headed for a single graph call.
    ``trace`` carries the assembly span across the dispatch-queue hop (the
    dispatch span's parent); None when no member request is traced.
    Padding is carried split: ``slots_padded`` (empty batch slots) vs
    ``tokens_padded`` (padded sequence positions in occupied slots)."""

    __slots__ = ("key", "batch", "arrays", "requests", "real",
                 "slots_padded", "tokens_padded", "trace")

    def __init__(self, key, batch, arrays, requests, real, slots_padded,
                 tokens_padded, trace=None):
        self.key = key
        self.batch = batch
        self.arrays = arrays
        self.requests = requests
        self.real = real
        self.slots_padded = slots_padded
        self.tokens_padded = tokens_padded
        self.trace = trace


class Batcher:
    """The continuous-batching pump: one thread that turns the admission
    queue into a stream of assembled batches on a bounded handoff queue
    (its blocking ``put`` is how dispatch pressure reaches admission)."""

    def __init__(self, admission: AdmissionQueue, bucketer, out_queue,
                 max_batch: int, window_s,
                 on_expired: Callable[[Request], None],
                 on_error: Callable[[Request, BaseException], None]):
        self._admission = admission
        self._bucketer = bucketer
        self._out = out_queue
        self._max_batch = max_batch
        # a float is a frozen window; a callable is re-read before every
        # batch pop (the live knob)
        self._window = window_s
        self._on_expired = on_expired
        self._on_error = on_error
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run,
                                        name="mxtpu-serving-batcher",
                                        daemon=True)
        self._thread.start()

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)

    def is_alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def _run(self) -> None:
        while True:
            window = self._window() if callable(self._window) \
                else self._window
            popped = self._admission.pop_bucket(self._max_batch, window)
            if popped is None:
                break
            batch_reqs, expired = popped
            for r in expired:
                self._on_expired(r)
            if not batch_reqs:
                continue
            try:
                batch = self._assemble(batch_reqs)
            except Exception as e:   # a poison batch fails its requests;
                for r in batch_reqs:     # the pump keeps pumping
                    self._on_error(r, e)
                continue
            self._out.put(batch)

    def _assemble(self, requests: List[Request]) -> _Batch:
        """Stamp the assembly time and pad-and-stack via the bucketer.

        Causal tracing: when any member request carries a trace, the
        assembly gets a ``serving.assemble`` span parented on the first
        traced request and linked to every other traced member (one batch,
        many causes).  Tracing off: every ``r.trace`` is None and the
        tracer is not touched."""
        sp = parent_req = None
        for r in requests:
            if r.trace is not None:
                sp = _tracing.tracer().begin(
                    "serving.assemble", parent=r.trace, activate=False)
                parent_req = r
                break
        t = time.monotonic()
        for r in requests:
            r.t_assemble = t
        try:
            arrays, bsz, real, slots_pad, tokens_pad = \
                self._bucketer.assemble(requests)
        except BaseException as exc:
            # a poison batch still records its assembly span
            if sp is not None:
                sp.annotate(error=type(exc).__name__)
                sp.finish()
            raise
        if sp is not None:
            for r in requests:
                if r.trace is not None and r is not parent_req:
                    sp.link(r.trace)
            sp.annotate(batch=bsz, real=real, slots_padded=slots_pad,
                        tokens_padded=tokens_pad)
            sp.finish()
        return _Batch(requests[0].key, bsz, arrays, requests, real,
                      slots_pad, tokens_pad, trace=sp)
