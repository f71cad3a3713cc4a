"""ModelServer and GenerationServer: serving over cached graphs.

Counterpart of ``mxnet_tpu/serving/server.py``.  ``ModelServer``::

    submit() -> AdmissionQueue (bounded, 429 past depth)
             -> batcher thread: shape-bucketed batch assembly
                (padding-length buckets, the BERT idiom)
             -> dispatch workers: one CachedGraph.raw call per batch and
                one batched device->host readback
             -> per-request results, metrics, flight-recorder records

Metrics (process-global registry): ``serving.request_us`` and
``serving.dispatch_us`` histograms, the ``serving.queue_depth`` gauge, and
the ``serving.requests``/``requests_done``/``rejected_429``/
``rejected_deadline``/``batches``/``tokens_real``/``tokens_padded``/
``slots_padded`` counters.

``GenerationServer`` is the iteration-level decode scheduler over a
paged KV cache (``serving.kv_cache``) and a ``CausalLM``'s
``cached_graph(entry="prefill"|"decode")`` graphs, which update one KV
pool in place (``gluon/cached_op.py``).  A decode step is, for each
``DECODE_ROWS`` running slots, one host-to-device copy of the step's
inputs and one replay, then one page-locked readback of the logits; the
greedy argmax runs on the host.  Its metrics:
``serving.ttft_us``, ``serving.decode_step_us``,
``serving.tokens_generated``, ``serving.decode_steps``, the
``serving.kv_blocks_used`` gauge, and the request counters above.

Knobs (``base.register_env``): ``MXTPU_SERVING_MAX_BATCH``,
``MXTPU_SERVING_QUEUE_DEPTH``, ``MXTPU_SERVING_DEADLINE_MS``,
``MXTPU_SERVING_WORKERS``, ``MXTPU_SERVING_BATCH_WINDOW_US``,
``MXTPU_SERVING_KV_BLOCK``, ``MXTPU_SERVING_KV_BLOCKS``,
``MXTPU_SERVING_DECODE_SLOTS``, ``MXTPU_SERVING_PREFILL_MODE``,
``MXTPU_SERVING_MAX_NEW_TOKENS``.

``ModelServer.from_exported`` serves an exported graph and its
parameters (``HybridBlock.export``) through ``SymbolBlock.imports``, as the
JAX package's (``mxnet_tpu/serving/server.py:222-231``).  A ``SymbolBlock``
is a ``HybridBlock``, so its batch buckets are captured graphs over the
same page-locked staging as any other block's; a ``Block`` that is not
hybrid (the JAX server jits it, ``_freeze_generic``) is served the same
way, inside a ``HybridBlock`` whose forward calls it.

Causal tracing (``MXTPU_TRACE``, ``observability.tracing``), as the JAX
package has it: ``submit`` opens a ``serving.request`` root (head-sampled;
a W3C parent the front door activated becomes its parent), the batcher a
``serving.assemble`` span linking the batch's requests, a dispatch worker
``serving.dispatch`` and ``serving.readback`` children, and ``_finish``
closes the root and puts its trace id on ``serving.request_us`` as an
exemplar (passed explicitly: no contextvar crosses into the workers).  A
worker holds its dispatch span as its active context while it runs the
batch (the JAX package begins it without activating it), so the stack
sampler tags the worker's frames with the batch's trace.
The span boundaries are the JAX package's, and the same asynchrony holds:
a replayed graph returns once it is queued, so ``serving.dispatch`` closes
before the card has worked, and the device time lands in
``serving.readback`` (the stream synchronise of :func:`readback`).  With
tracing off ``req.trace`` is None and the tracer is never touched.  A
generation opens ``serving.generate`` with ``serving.prefill`` and
``serving.decode_step`` children (a step linking its other requests).

Every completed request also lands in the flight recorder's request ring
(``observability.flight``), the dispatch workers and the decode loop beat
the watchdog's ``serving.dispatch`` and ``serving.decode`` touchpoints
(``observability.watchdog``), and a server's construction starts the
stack sampler when ``MXTPU_PROF_SAMPLE_HZ`` asks for it.
"""
from __future__ import annotations

import itertools
import queue as _queue
import signal
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..base import MXNetError, compute_dtype, get_env
from ..gluon.block import Block, HybridBlock, SymbolBlock
from ..observability import tracing as _tracing
from ..observability.flight import recorder as _flight_recorder
from ..observability.registry import registry
from ..observability.sampler import maybe_start_from_env as \
    _maybe_start_sampler
from ..observability.watchdog import touchpoint as _touchpoint
from .batcher import (AdmissionQueue, Batcher, DeadlineExceeded,
                      GenRequest, Request, RequestCancelled, ServerClosed,
                      ServerOverloaded)
from .buckets import Bucketer, NoBucketError
from .kv_cache import BlockKVCache

__all__ = ["ModelServer", "GenerationServer", "DECODE_ROWS",
           "decode_rows"]

MAX_BATCH_ENV = "MXTPU_SERVING_MAX_BATCH"
QUEUE_DEPTH_ENV = "MXTPU_SERVING_QUEUE_DEPTH"
DEADLINE_MS_ENV = "MXTPU_SERVING_DEADLINE_MS"
WORKERS_ENV = "MXTPU_SERVING_WORKERS"
BATCH_WINDOW_US_ENV = "MXTPU_SERVING_BATCH_WINDOW_US"
KV_BLOCK_ENV = "MXTPU_SERVING_KV_BLOCK"
KV_BLOCKS_ENV = "MXTPU_SERVING_KV_BLOCKS"
DECODE_SLOTS_ENV = "MXTPU_SERVING_DECODE_SLOTS"
PREFILL_MODE_ENV = "MXTPU_SERVING_PREFILL_MODE"
MAX_NEW_ENV = "MXTPU_SERVING_MAX_NEW_TOKENS"


def _key_str(key: Tuple) -> str:
    """Compact bucket tag for records: ``32:int32|32:int32`` (dtype
    included, so buckets differing only in dtype stay apart)."""
    parts = []
    for shape, dt in key:
        parts.append(("x".join(str(s) for s in shape) or "scalar")
                     + ":" + str(dt))
    return "|".join(parts)


def _live_window_s() -> float:
    """The knob-governed batch window, re-read before every batch pop."""
    return float(get_env(BATCH_WINDOW_US_ENV)) / 1e6


def readback(outs: Sequence[torch.Tensor]) -> list:
    """One batched device->host readback: every output's copy is queued
    on the current stream into page-locked host memory, then the stream is
    synchronised once.  CPU tensors are returned as they are."""
    if not outs or outs[0].device.type != "cuda":
        return [t.numpy() for t in outs]
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            for t in outs]
    for h, t in zip(host, outs):
        h.copy_(t, non_blocking=True)
    torch.cuda.current_stream(outs[0].device).synchronize()
    return [h.numpy() for h in host]


def _host(x) -> np.ndarray:
    """A request input as a host array in its serving dtype."""
    a = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)
    cd = compute_dtype(a.dtype)
    return a.astype(cd) if a.dtype != cd else a


class _Hybrid(HybridBlock):
    """A ``Block`` that is not hybrid, as a ``HybridBlock`` whose forward
    calls it, so that ``cached_graph`` captures it."""

    def __init__(self, block: Block):
        super().__init__(prefix=block.prefix)
        self.block = block

    def forward(self, *args):
        return self.block(*args)


def _servable(block) -> HybridBlock:
    if isinstance(block, HybridBlock):
        return block
    if isinstance(block, Block):
        return _Hybrid(block)
    raise MXNetError(f"ModelServer serves a gluon Block, got "
                     f"{type(block).__name__}")


class ModelServer:
    """Continuous-batching inference server over one Block.

    Requests are single samples without the batch dimension; the server
    pads them into bucketed batches and runs one forward per batch on the
    block's device.  ``submit`` is non-blocking and returns a
    :class:`~mxnet_tpu_torch.serving.batcher.Request` future; ``infer`` is
    the blocking wrapper.  ``start()`` spawns the batcher and N dispatch
    workers; ``stop(drain=True)`` closes admission, drains every queued
    request and joins the threads.
    """

    def __init__(self, block, *, max_batch: Optional[int] = None,
                 queue_depth: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 workers: Optional[int] = None,
                 length_buckets: Optional[Sequence[int]] = None,
                 pad_axis: int = 0,
                 batch_buckets: Optional[Sequence[int]] = None,
                 batch_window_us: Optional[float] = None,
                 unpad_outputs: bool = True, flight=None):
        self._block = _servable(block)
        self.unpad_outputs = unpad_outputs
        self.max_batch = int(get_env(MAX_BATCH_ENV) if max_batch is None
                             else max_batch)
        self.queue_depth = int(get_env(QUEUE_DEPTH_ENV)
                               if queue_depth is None else queue_depth)
        self.deadline_ms = float(get_env(DEADLINE_MS_ENV)
                                 if deadline_ms is None else deadline_ms)
        self.workers = max(1, int(get_env(WORKERS_ENV)
                                  if workers is None else workers))
        window_s = _live_window_s if batch_window_us is None \
            else float(batch_window_us) / 1e6
        self._bucketer = Bucketer(self.max_batch,
                                  length_buckets=length_buckets,
                                  pad_axis=pad_axis,
                                  batch_buckets=batch_buckets)
        reg = registry()
        self._g_depth = reg.gauge(
            "serving.queue_depth",
            help="admission-queue depth (requests waiting for assembly)")
        self._h_request = reg.histogram(
            "serving.request_us",
            help="per-request end-to-end latency (enqueue to done)")
        self._h_dispatch = reg.histogram(
            "serving.dispatch_us",
            help="per-batch forward + readback wall time")
        self._c_requests = reg.counter(
            "serving.requests", help="requests admitted")
        self._c_done = reg.counter(
            "serving.requests_done", help="requests completed ok")
        self._c_rej_429 = reg.counter(
            "serving.rejected_429",
            help="requests rejected at admission (queue full)")
        self._c_rej_deadline = reg.counter(
            "serving.rejected_deadline",
            help="requests rejected at assembly (deadline expired)")
        self._c_batches = reg.counter(
            "serving.batches", help="batched forwards dispatched")
        self._c_real = reg.counter(
            "serving.tokens_real",
            help="real (unpadded) elements served")
        self._c_padded = reg.counter(
            "serving.tokens_padded",
            help="padded sequence positions within occupied batch slots")
        self._c_slots_padded = reg.counter(
            "serving.slots_padded",
            help="empty batch slots dispatched (batch-bucket waste)")
        self._flight = _flight_recorder() if flight is None else flight
        self._admission = AdmissionQueue(self.queue_depth,
                                         gauge=self._g_depth)
        self._out: _queue.Queue = _queue.Queue(
            maxsize=max(2, 2 * self.workers))
        self._batcher = Batcher(self._admission, self._bucketer,
                                self._out, self.max_batch,
                                window_s, self._expire,
                                on_error=self._fail)
        self._graphs: Dict[Tuple, object] = {}
        self._compile_lock = threading.Lock()
        self._lifecycle_lock = threading.Lock()
        self._threads = []
        self._started = False
        self._stopped = False
        self._drain_down = False
        self._rid = itertools.count()
        self._prev_sigterm = None
        # the watchdog's heartbeat: one beat per worker-loop iteration
        # (idle pops included, so only a wedged dispatch goes silent),
        # thresholded on the dispatch histogram's recent p99
        self._tp_dispatch = _touchpoint("serving.dispatch",
                                        hist="serving.dispatch_us")
        _maybe_start_sampler()

    @classmethod
    def from_exported(cls, symbol_file: str, input_names,
                      param_file: Optional[str] = None, ctx=None, **kw
                      ) -> "ModelServer":
        """Serve an exported pair (``HybridBlock.export``): the graph and
        parameters through ``SymbolBlock.imports`` on ``ctx`` (the card
        unless the caller asks for another), ``kw`` as for the
        constructor."""
        return cls(SymbolBlock.imports(symbol_file, input_names,
                                       param_file, ctx=ctx), **kw)

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "ModelServer":
        with self._lifecycle_lock:
            if self._started:
                return self
            if self._stopped:
                raise ServerClosed("server already stopped")
            self._batcher.start()
            for i in range(self.workers):
                t = threading.Thread(target=self._worker_loop,
                                     name=f"mxtpu-serving-worker-{i}",
                                     daemon=True)
                t.start()
                self._threads.append(t)
            self._started = True
        return self

    def stop(self, drain: bool = True, timeout: Optional[float] = None
             ) -> None:
        """Close admission (further submits raise ServerClosed), then
        either drain every queued request through the normal path
        (``drain=True``) or fail them at once."""
        with self._lifecycle_lock:
            if self._stopped:
                return
            self._stopped = True
            self._admission.close()
            if not drain:
                for r in self._admission.shed():
                    self._finish(r, error=ServerClosed(
                        "server stopped without draining"))
            if self._started:
                self._batcher.join(timeout)
                if self._batcher.is_alive():
                    # the batcher may still be putting batches: sentinels
                    # would race ahead of them, so flag the workers down
                    self._drain_down = True
                else:
                    for _ in self._threads:
                        try:
                            self._out.put(None, timeout=1.0)
                        except _queue.Full:
                            self._drain_down = True
                            break
                for t in self._threads:
                    t.join(timeout)
            else:
                for r in self._admission.shed():
                    self._finish(r, error=ServerClosed(
                        "server stopped before start"))
            self._g_depth.set(0)

    def __enter__(self) -> "ModelServer":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.stop(drain=exc_type is None)

    def install_sigterm(self) -> None:
        """Chain a SIGTERM handler that drains and stops the server, then
        calls the previous handler (see :func:`_install_sigterm`)."""
        self._prev_sigterm = _install_sigterm(self, "mxtpu-serving")

    def uninstall_sigterm(self) -> None:
        if self._prev_sigterm is not None:
            signal.signal(signal.SIGTERM, self._prev_sigterm)
            self._prev_sigterm = None

    # -- client surface -----------------------------------------------------
    def submit(self, *inputs, deadline_ms: Optional[float] = None
               ) -> Request:
        """Enqueue one sample (inputs without the batch dim); returns a
        Request future.  Raises :class:`ServerOverloaded` when the
        admission queue is full, :class:`ServerClosed` after stop, and
        ``NoBucketError`` when no shape bucket fits."""
        arrs = tuple(_host(x) for x in inputs)
        key = self._bucketer.sample_key(arrs)
        ms = self.deadline_ms if deadline_ms is None else float(deadline_ms)
        deadline = (time.monotonic() + ms / 1e3) if ms > 0 else None
        req = Request(next(self._rid), arrs, key, deadline)
        # the causal-tracing root: one trace per request, head-sampled at
        # admission, finished in _finish on a worker thread
        req.trace = _tracing.tracer().begin(
            "serving.request", activate=False,
            args={"rid": req.rid, "bucket": _key_str(key)})
        try:
            self._admission.submit(req)
        except BaseException as exc:
            # admission refused the request: nobody downstream will
            # finish its span, so close it first
            if req.trace is not None:
                req.trace.annotate(error=type(exc).__name__)
                req.trace.finish()
            if isinstance(exc, ServerOverloaded):
                self._c_rej_429.inc()
            raise
        self._c_requests.inc()
        return req

    def infer(self, *inputs, timeout: Optional[float] = None,
              deadline_ms: Optional[float] = None):
        """Blocking convenience: submit + wait; returns host numpy
        output(s)."""
        return self.submit(*inputs, deadline_ms=deadline_ms).result(timeout)

    def warmup(self, *samples) -> int:
        """Build every (shape bucket, batch bucket) graph the given
        example samples imply, so no live request pays the first run
        (the kernels' build included).  Each sample is one request's input
        tuple (or a single array).  Returns the number of graphs."""
        for sample in samples:
            sample = sample if isinstance(sample, (tuple, list)) \
                else (sample,)
            key = self._bucketer.sample_key([_host(a) for a in sample])
            for bsz in self._bucketer.batch_buckets:
                self._graph_for(key, bsz)
        return len(self._graphs)

    def stats(self) -> dict:
        """Serving counters plus the sequence-padding efficiency (real
        positions over positions dispatched in occupied slots)."""
        real, padded = self._c_real.n, self._c_padded.n
        return {
            "requests": self._c_requests.n,
            "done": self._c_done.n,
            "rejected_429": self._c_rej_429.n,
            "rejected_deadline": self._c_rej_deadline.n,
            "batches": self._c_batches.n,
            "queue_depth": self._g_depth.value,
            "tokens_real": real,
            "tokens_padded": padded,
            "slots_padded": self._c_slots_padded.n,
            "batch_efficiency": round(real / (real + padded), 4)
            if real + padded else 0.0,
            "executables": len(self._graphs),
        }

    # -- graph resolution (cold path) ---------------------------------------
    def _build_graph(self, block, key: Tuple, batch: int):
        """The block's cached graph for one (shape bucket, batch bucket)
        signature, run once on zeros."""
        examples = [np.zeros((batch,) + tuple(shape), dtype=dt)
                    for shape, dt in key]
        return block.cached_graph(*examples).raw

    def _graph_for(self, key: Tuple, batch: int):
        """The graph for one (shape bucket, batch bucket): built on first
        use (``warmup()`` prebuilds), then a dict hit."""
        gk = (key, batch)
        g = self._graphs.get(gk)
        if g is not None:
            return g
        with self._compile_lock:
            g = self._graphs.get(gk)
            if g is None:
                g = self._build_graph(self._block, key, batch)
                self._graphs[gk] = g
            return g

    # -- blue/green weight swap ----------------------------------------------
    def swap_block(self, new_block) -> int:
        """Rolling blue/green swap: build ``new_block``'s graph for every
        signature the current set serves, outside the lock while live
        traffic keeps dispatching on the old graphs, then flip the block
        and the whole graph dict at once.  In-flight batches hold the old
        graph and complete on it; no request drops.  Returns the number of
        graphs in the new set."""
        new_block = _servable(new_block)
        staged: Dict[Tuple, object] = {}
        for gk in list(self._graphs):
            staged[gk] = self._build_graph(new_block, gk[0], gk[1])
        with self._compile_lock:
            # a signature first built while we staged: build it too
            for gk in list(self._graphs):
                if gk not in staged:
                    staged[gk] = self._build_graph(new_block, gk[0], gk[1])
            self._block = new_block
            self._graphs = staged
        return len(staged)

    # -- dispatch-worker scaling ---------------------------------------------
    def set_workers(self, n: int) -> int:
        """Retarget the dispatch-worker count of a running server.  Growth
        spawns workers at once; a shrink retires one worker per sentinel,
        after the batches already queued ahead of it, so no request drops.
        Returns the new target."""
        n = max(1, int(n))
        with self._lifecycle_lock:
            if self._stopped:
                return self.workers
            delta = n - self.workers
            if delta == 0:
                return n
            if not self._started:
                self.workers = n
                return n
            if delta > 0:
                for _ in range(delta):
                    t = threading.Thread(
                        target=self._worker_loop,
                        name=f"mxtpu-serving-worker-{len(self._threads)}",
                        daemon=True)
                    t.start()
                    self._threads.append(t)
            else:
                for _ in range(-delta):
                    try:
                        self._out.put(None, timeout=1.0)
                    except _queue.Full:
                        # a wedged dispatch queue: keep the worker we
                        # failed to retire
                        n += 1
            self.workers = n
            return n

    # -- dispatch (hot path) -------------------------------------------------
    def _worker_loop(self) -> None:
        tp = self._tp_dispatch
        while True:
            tp.beat()
            try:
                batch = self._out.get(timeout=0.25)
            except _queue.Empty:
                if self._drain_down:
                    break
                continue
            if batch is None:
                break
            try:
                graph = self._graph_for(batch.key, batch.batch)
                self._dispatch_batch(graph, batch)
            except Exception as e:  # a failed batch fails its requests,
                for req in batch.requests:      # never the server
                    if not req.done():
                        self._finish(req, error=e)

    def _dispatch_batch(self, graph, batch) -> None:
        """One forward for the whole bucket, one batched device->host
        readback, then per-request fan-out.  The ``serving.dispatch`` span
        (a child of the batch's assembly span) closes when the forward is
        queued; the card's time lands in its ``serving.readback`` child."""
        sp = None if batch.trace is None else _tracing.tracer().begin(
            "serving.dispatch", parent=batch.trace, activate=False,
            args={"batch": batch.batch, "bucket": _key_str(batch.key)})
        rb = None
        try:
            t0 = time.monotonic()
            for req in batch.requests:
                req.t_dispatch = t0
            # the dispatch span is this worker's active context while it
            # runs, so the stack sampler tags the worker's frames with the
            # batch's trace (activate(None) is a no-op)
            with _tracing.activate(sp):
                flat = graph(*batch.arrays)
                rb = None if sp is None else _tracing.tracer().begin(
                    "serving.readback", parent=sp, activate=False)
                outs = readback(flat)
        except BaseException as exc:
            # a failed batch still records its dispatch span
            if sp is not None:
                sp.annotate(error=type(exc).__name__)
                if rb is not None:
                    rb.finish()
                sp.finish()
            raise
        if rb is not None:
            rb.finish()
            sp.finish()
        self._h_dispatch.observe((time.monotonic() - t0) * 1e6)
        self._c_batches.inc()
        self._c_real.inc(batch.real)
        self._c_padded.inc(batch.tokens_padded)
        self._c_slots_padded.inc(batch.slots_padded)
        for i, req in enumerate(batch.requests):
            req.batch_size = batch.batch
            row = self._unpad_row(tuple(o[i] for o in outs), req)
            self._finish(req, result=row[0] if len(row) == 1 else row)

    def _unpad_row(self, row, req: Request):
        """Undo length-bucket padding on a request's outputs: slice axis
        ``pad_axis`` back to the request's real length where its size
        equals the padded bucket (BERT's MLM logits trim; a pooled output
        passes through).  A pooled dim that coincides with a bucket size is
        indistinguishable from a length axis: construct with
        ``unpad_outputs=False`` for such models.  The padded positions'
        values are a model contract: a sequence model must take a mask or
        valid-length input, passed as part of the request."""
        bkt = self._bucketer
        if not bkt.length_buckets or not self.unpad_outputs:
            return row
        ax = bkt.pad_axis
        padded = req.key[0][0][ax]
        real = req.inputs[0].shape[ax]
        if real == padded:
            return row
        out = []
        for o in row:
            if o.ndim > ax and o.shape[ax] == padded:
                sl = [slice(None)] * o.ndim
                sl[ax] = slice(0, real)
                o = o[tuple(sl)]
            out.append(o)
        return tuple(out)

    def _finish(self, req: Request, result=None, error=None) -> None:
        """Complete one request: its trace, latency histogram, counters,
        flight record; wake the client."""
        req.t_done = time.monotonic()
        req._result = result
        req._error = error
        dur_us = (req.t_done - req.t_enqueue) * 1e6
        trace_id = None
        if req.trace is not None:
            trace_id = req.trace.trace_id
            if error is not None:
                req.trace.annotate(error=type(error).__name__)
            req.trace.finish()
        if error is None:
            # the explicit trace_id puts the exemplar on this request's
            # trace (no contextvar crosses the worker-thread hop)
            self._h_request.observe(dur_us, trace_id=trace_id)
            self._c_done.inc()
        self._flight.record_request(
            request_id=req.rid,
            enqueue=round(req.t_enqueue, 6),
            assemble=round(req.t_assemble, 6),
            dispatch=round(req.t_dispatch, 6),
            done=round(req.t_done, 6),
            bucket=_key_str(req.key),
            batch_size=req.batch_size,
            us=round(dur_us, 1),
            trace_id=trace_id,
            ok=error is None)
        req._event.set()

    def _expire(self, req: Request) -> None:
        self._c_rej_deadline.inc()
        self._finish(req, error=DeadlineExceeded(
            f"request {req.rid} spent its deadline queued (429-style); "
            f"the server is over capacity — back off"))

    def _fail(self, req: Request, error: BaseException) -> None:
        """Assembly-failure path: same accounting as every other
        completion (flight record, timestamps), with an error."""
        self._finish(req, error=error)


def _install_sigterm(server, name: str):
    """Chain a SIGTERM handler that drains and stops ``server``, then calls
    the previous handler; returns the previous handler.  The drain runs on
    its own non-daemon thread: the signal may have interrupted a frame on
    this very thread holding the locks ``stop()`` needs, so the handler
    returns at once and the drain thread keeps the process alive until
    shutdown completes."""
    prev = signal.getsignal(signal.SIGTERM)

    def drain_then_chain(signum, frame):
        server.stop(drain=True)
        if callable(prev) and prev not in (signal.SIG_IGN, signal.SIG_DFL):
            prev(signum, frame)

    def handler(signum, frame):
        threading.Thread(target=drain_then_chain, args=(signum, frame),
                         name=f"{name}-sigterm-drain",
                         daemon=False).start()

    signal.signal(signal.SIGTERM, handler)
    return prev


def _as_error(exc: BaseException) -> Exception:
    """What a failed generation raises to its caller: the exception, or an
    ``MXNetError`` carrying an interrupt's message."""
    return exc if isinstance(exc, Exception) else MXNetError(str(exc))


#: the one row count of the decode graph: a step replays it once for each
#: DECODE_ROWS running slots, padded rows pointing at scratch, so the
#: GEMMs' shapes (and so their algorithms) never change with the slot
#: count, and a slot's greedy tokens stay bit for bit those it gets alone
DECODE_ROWS = 16


def decode_rows(slots: int) -> int:
    """The rows a decode step stages for ``slots`` running slots: whole
    replays of the ``DECODE_ROWS``-row decode graph."""
    return -(-max(1, int(slots)) // DECODE_ROWS) * DECODE_ROWS


class _Staging:
    """A step's int32 inputs staged for one host-to-device copy: a
    page-locked host buffer cut into the numpy arrays the scheduler
    fills (``host``), and its device twin cut into the tensors a graph
    reads (``args``; on the CPU the same memory)."""

    def __init__(self, shapes, device: torch.device):
        sizes = [int(np.prod(s)) for s in shapes]
        on_card = device.type == "cuda"
        self._host = torch.zeros(sum(sizes), dtype=torch.int32,
                                 pin_memory=on_card)
        self._dev = self._host.to(device) if on_card else self._host
        offs = np.cumsum([0] + sizes)
        self.host = [self._host[a:b].view(s).numpy()
                     for a, b, s in zip(offs[:-1], offs[1:], shapes)]
        self.args = [self._dev[a:b].view(s)
                     for a, b, s in zip(offs[:-1], offs[1:], shapes)]

    def push(self) -> list:
        """Copy the host buffer to the device (queued on the current
        stream) and return the device tensors."""
        if self._dev is not self._host:
            self._dev.copy_(self._host, non_blocking=True)
        return self.args


class GenerationServer:
    """Iteration-level (token-level continuous-batching) decode scheduler
    over a paged KV cache, the JAX package's ``GenerationServer``
    (``mxnet_tpu/serving/server.py:663-1348``), its tracing, flight
    records, sampler and watchdog touchpoint included.

    The schedulable unit is one decode step:

    - ``submit_generate(prompt)`` enqueues a generation (bounded queue,
      429 past the depth);
    - admission into the running batch gates on a worst-case KV block
      reservation against the :class:`~.kv_cache.BlockKVCache` pool, so
      an admitted request can never exhaust the pool mid-decode;
    - each admitted prompt runs one **prefill** graph (batch 1, padded to
      a prompt bucket) that writes its K/V into the request's blocks and
      yields the first token (TTFT is measured here);
    - every iteration replays one **decode** graph over all running
      slots; finished requests leave their slot and queued prefills join
      at the next iteration.

    ``MXTPU_SERVING_PREFILL_MODE`` (read live per iteration):
    ``"interleave"`` admits at most one prefill per decode iteration,
    ``"step"`` prefills every admissible queued request before the next
    decode step.

    The model contract is ``hybrid_prefill``, ``hybrid_decode`` and
    ``init_kv_pool`` (``gluon.model_zoo.transformer.CausalLM``).  The
    graphs (``cached_graph(entry=...)``) update the server's one pool in
    place; the server owns them, and ``stop()`` drops them.  The one
    decode graph runs at ``DECODE_ROWS`` rows, replayed once for each
    ``DECODE_ROWS`` slots, not at the slot count (a departure from the
    JAX package, whose decode signature is the slot count): the GEMMs'
    shapes stay fixed, so a slot's greedy tokens are bit for bit those it
    gets alone at any slot count."""

    def __init__(self, block, *, slots: Optional[int] = None,
                 kv_block: Optional[int] = None,
                 kv_blocks: Optional[int] = None,
                 queue_depth: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 max_new_tokens: Optional[int] = None,
                 prompt_buckets: Sequence[int] = (16, 32, 64),
                 eos: Optional[int] = None, flight=None):
        for need in ("hybrid_prefill", "hybrid_decode", "init_kv_pool"):
            if not callable(getattr(block, need, None)):
                raise MXNetError(
                    f"generation serving needs a block with {need}(); see "
                    f"gluon.model_zoo.transformer.CausalLM")
        self._block = block
        self._slots = max(1, int(get_env(DECODE_SLOTS_ENV)
                                 if slots is None else slots))
        self._target_slots = self._slots
        self.queue_depth = int(get_env(QUEUE_DEPTH_ENV)
                               if queue_depth is None else queue_depth)
        self.deadline_ms = float(get_env(DEADLINE_MS_ENV)
                                 if deadline_ms is None else deadline_ms)
        self.max_new_cap = max(1, int(get_env(MAX_NEW_ENV)
                                      if max_new_tokens is None
                                      else max_new_tokens))
        self.eos = eos
        self._buckets = tuple(sorted(set(int(b) for b in prompt_buckets)))
        self._kv = BlockKVCache(kv_blocks, kv_block)
        # decode table width: worst-case blocks for the largest prompt
        # bucket plus the generation cap
        bs = self._kv.block_size
        self._max_blocks = -(-(self._buckets[-1] + self.max_new_cap) // bs)
        self._pool = block.init_kv_pool(self._kv.n_blocks, bs)
        self.device = self._pool.device
        self._tables: Dict[int, object] = {}
        reg = registry()
        self._g_depth = reg.gauge(
            "serving.queue_depth",
            help="admission-queue depth (requests waiting for assembly)")
        self._h_request = reg.histogram(
            "serving.request_us",
            help="per-request end-to-end latency (enqueue to done)")
        self._h_ttft = reg.histogram(
            "serving.ttft_us",
            help="time to first token: generation enqueue to the "
                 "prefill's first emitted token")
        self._h_step = reg.histogram(
            "serving.decode_step_us",
            help="one decode step: inputs copied in, one replay, the "
                 "batched logits readback")
        self._c_requests = reg.counter(
            "serving.requests", help="requests admitted")
        self._c_done = reg.counter(
            "serving.requests_done", help="requests completed ok")
        self._c_rej_429 = reg.counter(
            "serving.rejected_429",
            help="requests rejected at admission (queue full)")
        self._c_rej_deadline = reg.counter(
            "serving.rejected_deadline",
            help="requests rejected at assembly (deadline expired)")
        self._c_tokens = reg.counter(
            "serving.tokens_generated",
            help="tokens emitted by the generation scheduler (prefill "
                 "first tokens included)")
        self._c_steps = reg.counter(
            "serving.decode_steps", help="decode iterations dispatched")
        self._flight = _flight_recorder() if flight is None else flight
        self._queue: List[GenRequest] = []
        self._running: List[Optional[GenRequest]] = [None] * self._slots
        self._lock = threading.Condition()
        # bucket -> (graph, staging), and the decode graph with a staging
        # for each replay of a step: built with the graph, so a step
        # allocates nothing but its outputs
        self._prefill_graphs: Dict[int, tuple] = {}
        self._decode = None
        self._decode_stages: List[_Staging] = []
        self._compile_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        self._abort = False
        self._rid = itertools.count()
        self._prev_sigterm = None
        # the watchdog's heartbeat: bumped every scheduler iteration and
        # inside the idle wait, thresholded on the decode step's recent
        # p99 (a wedged step goes silent, an idle scheduler never does)
        self._tp_decode = _touchpoint("serving.decode",
                                      hist="serving.decode_step_us")
        _maybe_start_sampler()

    # -- lifecycle ----------------------------------------------------
    def start(self) -> "GenerationServer":
        with self._lock:
            if self._thread is not None:
                return self
            if self._closed:
                raise ServerClosed("server already stopped")
            self._thread = threading.Thread(
                target=self._run, name="mxtpu-serving-decode-scheduler",
                daemon=True)
            self._thread.start()
        return self

    def stop(self, drain: bool = True,
             timeout: Optional[float] = None) -> None:
        """Close admission; ``drain=True`` finishes every queued and
        running generation through the normal path, else they fail with
        ServerClosed (their KV blocks released either way)."""
        with self._lock:
            if self._closed and self._thread is None:
                return
            self._closed = True
            if not drain:
                self._abort = True
            self._lock.notify_all()
            t = self._thread
        if t is not None:
            t.join(timeout)
        if t is None or not t.is_alive():
            # never started (or fully joined): fail whatever remains
            with self._lock:
                shed, self._queue = self._queue, []
                run = [r for r in self._running if r is not None]
                self._running = [None] * self._slots
            for r in shed + run:
                self._finish_gen(r, error=ServerClosed(
                    "server stopped" if t is not None
                    else "server stopped before start"))
            self._g_depth.set(0)
            # the graphs hold the pool and their own memory: a stopped
            # server never replays them again
            with self._compile_lock:
                self._prefill_graphs = {}
                self._decode = None
                self._decode_stages = []
        with self._lock:
            self._thread = None

    def __enter__(self) -> "GenerationServer":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.stop(drain=exc_type is None)

    def install_sigterm(self) -> None:
        """Chain a SIGTERM handler that drains and stops the scheduler
        (every queued and running generation finishes and releases its KV
        blocks), then calls the previous handler."""
        self._prev_sigterm = _install_sigterm(self, "mxtpu-serving-gen")

    def uninstall_sigterm(self) -> None:
        if self._prev_sigterm is not None:
            signal.signal(signal.SIGTERM, self._prev_sigterm)
            self._prev_sigterm = None

    # -- client surface -----------------------------------------------
    def submit_generate(self, prompt, max_new_tokens: Optional[int] = None,
                        deadline_ms: Optional[float] = None,
                        eos: Optional[int] = None) -> GenRequest:
        """Enqueue one generation: ``prompt`` is a 1-D sequence of token
        ids; returns a :class:`GenRequest` whose ``result()`` is the
        greedy token ids (EOS included when hit).  Raises
        :class:`ServerOverloaded` past the queue depth (429),
        :class:`NoBucketError` when the prompt fits no bucket or the
        request could never fit the KV pool, and ``MXNetError`` past the
        server's ``max_new_tokens`` cap (the cap sizes the decode
        tables)."""
        arr = np.ascontiguousarray(np.asarray(prompt).ravel(),
                                   dtype=np.int32)
        plen = int(arr.shape[0])
        if plen < 1:
            raise MXNetError("empty prompt")
        self._bucket_for(plen)          # raises NoBucketError past max
        mnt = self.max_new_cap if max_new_tokens is None \
            else int(max_new_tokens)
        if mnt < 1:
            raise MXNetError("max_new_tokens must be >= 1")
        if mnt > self.max_new_cap:
            raise MXNetError(
                f"max_new_tokens {mnt} exceeds the server cap "
                f"{self.max_new_cap} (the cap sizes the decode tables; "
                f"construct the server with a larger max_new_tokens)")
        if not self._kv.fits(plen, mnt):
            raise NoBucketError(
                f"prompt of {plen} + {mnt} new tokens needs "
                f"{self._kv.blocks_needed(plen, mnt)} KV blocks; the pool "
                f"holds {self._kv.capacity}")
        ms = self.deadline_ms if deadline_ms is None else float(deadline_ms)
        deadline = (time.monotonic() + ms / 1e3) if ms > 0 else None
        req = GenRequest(next(self._rid), arr, mnt, deadline,
                         self.eos if eos is None else eos)
        req.trace = _tracing.tracer().begin(
            "serving.generate", activate=False,
            args={"rid": req.rid, "prompt": plen, "max_new": mnt})
        try:
            with self._lock:
                if self._closed:
                    raise ServerClosed("server is shut down")
                if len(self._queue) >= self.queue_depth:
                    self._c_rej_429.inc()
                    raise ServerOverloaded(
                        f"admission queue full ({self.queue_depth} deep) "
                        f"— retry with backoff (429)")
                self._queue.append(req)
                self._g_depth.set(len(self._queue))
                self._lock.notify_all()
        except BaseException as exc:
            # rejected before entering the pipeline: close its span here
            if req.trace is not None:
                req.trace.annotate(error=type(exc).__name__)
                req.trace.finish()
            raise
        self._c_requests.inc()
        return req

    def generate(self, prompt, timeout: Optional[float] = None, **kw):
        """Blocking convenience: submit + wait; returns the generated token
        ids."""
        return self.submit_generate(prompt, **kw).result(timeout)

    def cancel(self, req: GenRequest) -> bool:
        """Cancel an in-flight generation (the stream-disconnect path): a
        queued request fails at once; a running one is marked and leaves
        the batch at the next iteration boundary.  Either way
        :meth:`_finish_gen` releases its KV blocks.  Returns False when
        the request had already completed."""
        with self._lock:
            if req.done():
                return False
            queued = req in self._queue
            if queued:
                self._queue.remove(req)
                self._g_depth.set(len(self._queue))
            else:
                req.cancelled = True
        if queued:
            self._finish_gen(req, error=RequestCancelled(
                f"generation {req.rid} cancelled while queued"))
        return True

    def warmup(self) -> int:
        """Build the decode graph, with a staging for each of the current
        slot count's replays, and every prompt bucket's prefill graph, so
        no live generation pays a build or a capture.  Returns the number
        of graphs resident."""
        self._decode_graph(decode_rows(self._slots) // DECODE_ROWS)
        for b in self._buckets:
            self._prefill_graph(b)
        return self._graph_count()

    def stats(self) -> dict:
        with self._lock:
            occupied = sum(1 for r in self._running if r is not None)
            depth = len(self._queue)
        return {
            "requests": self._c_requests.n,
            "done": self._c_done.n,
            "rejected_429": self._c_rej_429.n,
            "rejected_deadline": self._c_rej_deadline.n,
            "queue_depth": depth,
            "slots": self._slots,
            "decode_rows": decode_rows(self._slots),
            "slots_occupied": occupied,
            "tokens_generated": self._c_tokens.n,
            "decode_steps": self._c_steps.n,
            "kv_blocks_used": self._kv.used(),
            "kv_blocks_reserved": self._kv.reserved(),
            "kv_blocks_total": self._kv.capacity,
            "executables": self._graph_count(),
        }

    def _graph_count(self) -> int:
        return len(self._prefill_graphs) + (self._decode is not None)

    def graph_stats(self) -> dict:
        """Each prompt bucket's prefill graph and the decode graph, by its
        rows: ``CachedGraph.stats()`` (replays, capture ms, pool bytes,
        the bytes a replay copies out)."""
        decode = self._decode
        return {"prefill": {b: g.stats() for b, (g, _) in
                            sorted(self._prefill_graphs.items())},
                "decode": {} if decode is None
                else {DECODE_ROWS: decode.stats()}}

    @property
    def pool(self) -> torch.Tensor:
        """The KV pool every graph of this server updates in place."""
        return self._pool

    # -- slot-count control -------------------------------------------
    @property
    def decode_slots(self) -> int:
        return self._slots

    def set_decode_slots(self, n: int) -> None:
        """Retarget the running-batch slot count.  Takes effect between
        iterations: growth at once, a shrink once occupancy allows;
        running requests are never evicted.  Every slot count replays the
        one decode graph, so none captures a graph."""
        with self._lock:
            self._target_slots = max(1, int(n))
            self._lock.notify_all()

    # -- graph resolution (cold path) ---------------------------------
    def _bucket_for(self, plen: int) -> int:
        for b in self._buckets:
            if b >= plen:
                return b
        raise NoBucketError(
            f"prompt length {plen} exceeds the largest prompt bucket "
            f"{self._buckets[-1]}")

    def _prefill_graph(self, bucket: int) -> tuple:
        g = self._prefill_graphs.get(bucket)
        if g is not None:
            return g
        with self._compile_lock:
            g = self._prefill_graphs.get(bucket)
            if g is None:
                w = -(-bucket // self._kv.block_size)
                stage = _Staging([(1, bucket), (1,), (1, w)], self.device)
                # all-zero tables: the warm call's writes land in scratch
                graph = self._block.cached_graph(
                    *stage.push(), self._pool, entry="prefill")
                g = self._prefill_graphs[bucket] = (graph, stage)
            return g

    def _decode_graph(self, replays: int) -> tuple:
        """The decode graph and a staging for each of ``replays`` replays
        of a step: the first is the one the graph captured, the others are
        copied into it at their replay."""
        graph, stages = self._decode, self._decode_stages
        if graph is not None and len(stages) >= replays:
            return graph, stages
        with self._compile_lock:
            shapes = [(DECODE_ROWS,), (DECODE_ROWS,),
                      (DECODE_ROWS, self._max_blocks)]
            stages = self._decode_stages
            while len(stages) < replays:
                stages.append(_Staging(shapes, self.device))
            if self._decode is None:
                # all-zero tables: the warm call's writes land in scratch
                self._decode = self._block.cached_graph(
                    *stages[0].push(), self._pool, entry="decode")
            return self._decode, stages

    # -- the scheduler loop --------------------------------------------
    def _run(self) -> None:
        tp = self._tp_decode
        while True:
            tp.beat()
            with self._lock:
                while (not self._queue
                       and not any(r is not None for r in self._running)
                       and not self._closed):
                    self._lock.wait(0.1)
                    tp.beat()   # an idle scheduler keeps beating
                if self._abort:
                    shed, self._queue = self._queue, []
                    run = [r for r in self._running if r is not None]
                    self._running = [None] * self._slots
                    self._g_depth.set(0)
                else:
                    self._retarget_slots_locked()
                    admit, expired = self._admit_locked()
            if self._abort:
                for r in shed + run:
                    self._finish_gen(r, error=ServerClosed(
                        "server stopped without draining"))
                return
            for r in expired:
                self._expire_gen(r)
            for req in admit:
                bucket = self._bucket_for(len(req.prompt))
                self._prefill(self._prefill_graph(bucket), req, bucket)
            if any(r is not None for r in self._running):
                self._decode_step()
            elif not admit and not expired:
                if self._closed:
                    with self._lock:
                        idle = not self._queue and not any(
                            r is not None for r in self._running)
                    if idle:
                        return
                else:
                    # nothing flowed (the pool exhausted by an earlier
                    # admission wave): do not spin the condition hot
                    time.sleep(0.002)

    def _retarget_slots_locked(self) -> None:
        tgt = self._target_slots
        if tgt == self._slots:
            return
        occ = [r for r in self._running if r is not None]
        if tgt < self._slots and len(occ) > tgt:
            return          # a shrink waits for occupancy, never evicts
        self._running = occ + [None] * (tgt - len(occ))
        self._slots = tgt

    def _admit_locked(self):
        """Sweep deadline-expired queued requests, then pop the FIFO head
        while a slot is open, the KV pool honours the worst-case block
        reservation, and the live prefill mode's budget allows."""
        now = time.monotonic()
        expired = [r for r in self._queue
                   if r.deadline is not None and r.deadline < now]
        if expired:
            self._queue = [r for r in self._queue if r not in expired]
        free = sum(1 for r in self._running if r is None)
        mode = str(get_env(PREFILL_MODE_ENV)).lower()
        budget = free if mode == "step" else min(free, 1)
        admit = []
        while budget > 0 and self._queue:
            head = self._queue[0]
            table = self._kv.reserve(head.rid, len(head.prompt),
                                     head.max_new_tokens)
            if table is None:
                break           # blocks exhausted: FIFO holds the line
            self._tables[head.rid] = table
            self._queue.pop(0)
            admit.append(head)
            budget -= 1
        self._g_depth.set(len(self._queue))
        return admit, expired

    # -- dispatch (hot path) -------------------------------------------
    def _prefill(self, entry: tuple, req: GenRequest, bucket: int) -> None:
        """One prompt prefill (batch 1, padded to ``bucket``): writes the
        prompt's K/V into the request's blocks, emits the first token (the
        TTFT point) and seats the request in a running slot."""
        graph, stage = entry
        sp = None if req.trace is None else _tracing.tracer().begin(
            "serving.prefill", parent=req.trace, activate=False,
            args={"bucket": bucket})
        plen = len(req.prompt)
        try:
            table = self._kv.ensure(req.rid, plen)
            toks, seq_len, tb = stage.host
            toks.fill(0)
            toks[0, :plen] = req.prompt
            seq_len[0] = plen
            tb[0, :] = table.padded(tb.shape[1])
            req.t_prefill = time.monotonic()
            logits, _ = graph.raw(*stage.push(), self._pool)
            tok = int(readback([logits])[0][0].argmax())
        except BaseException as exc:  # the request fails and releases
            if sp is not None:            # its blocks
                sp.annotate(error=type(exc).__name__)
                sp.finish()
            self._finish_gen(req, error=_as_error(exc))
            if not isinstance(exc, Exception):
                raise
            return
        req.t_first = time.monotonic()
        # the span closes at the TTFT point: prep, replay and the first
        # token's readback
        if sp is not None:
            sp.finish()
        trace_id = None if req.trace is None else req.trace.trace_id
        self._h_ttft.observe((req.t_first - req.t_enqueue) * 1e6,
                             trace_id=trace_id)
        req.push_token(tok)
        req.pos = plen          # the new token decodes at position plen
        self._c_tokens.inc()
        if req.cancelled:
            self._finish_gen(req, error=RequestCancelled(
                f"generation {req.rid} cancelled mid-stream"))
            return
        if (req.eos is not None and tok == req.eos) \
                or len(req.tokens) >= req.max_new_tokens:
            self._finish_gen(req)
            return
        with self._lock:
            slot = self._running.index(None)
            self._running[slot] = req

    def _decode_step(self) -> None:
        """One iteration: for each ``DECODE_ROWS`` slots up to the last
        running one, a host-to-device copy of their tokens, positions and
        tables and a replay advancing each by a token; then one batched
        logits readback.  Finished requests free their slot and KV blocks
        before the next iteration's admissions."""
        occupied = [(i, r) for i, r in enumerate(self._running)
                    if r is not None]
        last = occupied[-1][0]
        graph, stages = self._decode_graph(last // DECODE_ROWS + 1)
        stages = stages[:last // DECODE_ROWS + 1]
        sp = None
        for _, r in occupied:
            if r.trace is not None:
                sp = _tracing.tracer().begin(
                    "serving.decode_step", parent=r.trace,
                    activate=False,
                    args={"occupied": len(occupied),
                          "slots": self._slots})
                for _, o in occupied:
                    if o.trace is not None and o is not r:
                        sp.link(o.trace)
                break
        try:
            # zeroed every step, so empty slots, padded rows and table
            # tails land in the scratch block, never a live request's
            for stage in stages:
                for a in stage.host:
                    a.fill(0)
            for i, r in occupied:
                # lazy block growth: back the write position (infallible
                # under the admission-time reservation)
                table = self._kv.ensure(r.rid, r.pos + 1)
                tokens, positions, tables = stages[i // DECODE_ROWS].host
                j = i % DECODE_ROWS
                tokens[j] = r.tokens[-1]
                positions[j] = r.pos
                tables[j, :] = table.padded(self._max_blocks)
            t0 = time.monotonic()
            logits = [graph.raw(*stage.push(), self._pool)[0]
                      for stage in stages]
            logits[-1] = logits[-1][:last % DECODE_ROWS + 1]
            lg = readback(logits)
        except BaseException as exc:  # the batch fails and releases
            if sp is not None:            # its blocks
                sp.annotate(error=type(exc).__name__)
                sp.finish()
            with self._lock:
                for i, _ in occupied:
                    self._running[i] = None
            for _, r in occupied:
                self._finish_gen(r, error=_as_error(exc))
            if not isinstance(exc, Exception):
                raise
            return
        trace_id = None if sp is None else sp.trace_id
        # the step span measures the replays and the batched readback
        if sp is not None:
            sp.finish()
        self._h_step.observe((time.monotonic() - t0) * 1e6,
                             trace_id=trace_id)
        self._c_steps.inc()
        finished = []
        for i, r in occupied:
            tok = int(lg[i // DECODE_ROWS][i % DECODE_ROWS].argmax())
            r.push_token(tok)
            r.pos += 1
            self._c_tokens.inc()
            if (r.cancelled or (r.eos is not None and tok == r.eos)
                    or len(r.tokens) >= r.max_new_tokens):
                finished.append((i, r))
        if finished:
            with self._lock:
                for i, _ in finished:
                    self._running[i] = None
            for _, r in finished:
                self._finish_gen(r, error=RequestCancelled(
                    f"generation {r.rid} cancelled mid-stream")
                    if r.cancelled else None)

    # -- completion paths ----------------------------------------------
    def _finish_gen(self, req: GenRequest, error=None) -> None:
        """Every generation exit path lands here (finish, deadline, cancel,
        abort, a failed prefill or step), so KV blocks and the unused tail
        of the reservation can never leak."""
        self._kv.release(req.rid)
        with self._lock:
            self._tables.pop(req.rid, None)
        req.t_done = time.monotonic()
        req._error = error
        dur_us = (req.t_done - req.t_enqueue) * 1e6
        trace_id = None
        if req.trace is not None:
            trace_id = req.trace.trace_id
            if error is not None:
                req.trace.annotate(error=type(error).__name__)
            req.trace.annotate(tokens=len(req.tokens))
            req.trace.finish()
        if error is None:
            self._h_request.observe(dur_us, trace_id=trace_id)
            self._c_done.inc()
        self._flight.record_request(
            request_id=req.rid,
            enqueue=round(req.t_enqueue, 6),
            assemble=round(req.t_prefill, 6),
            dispatch=round(req.t_first, 6),
            done=round(req.t_done, 6),
            bucket=f"gen:{len(req.prompt)}+{len(req.tokens)}",
            batch_size=self._slots,
            us=round(dur_us, 1),
            trace_id=trace_id,
            ok=error is None)
        req._event.set()
        req._wake_stream()

    def _expire_gen(self, req: GenRequest) -> None:
        self._c_rej_deadline.inc()
        self._finish_gen(req, error=DeadlineExceeded(
            f"generation {req.rid} spent its deadline queued (429-style); "
            f"the server is over capacity — back off"))
