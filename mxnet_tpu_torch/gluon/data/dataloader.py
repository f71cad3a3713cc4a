"""DataLoader: batched iteration with a threaded prefetch and a device
stage.

Counterpart of ``mxnet_tpu/gluon/data/dataloader.py`` (:1-574), with its
design: batches are built by a pool of ``num_workers`` threads (0 builds
them in the consumer's thread), handed over through a bounded prefetch
queue in sampler order, with at most ``num_workers + prefetch`` batches
in flight.  A worker's failure re-raises in the consumer as an
``MXNetError`` that names the worker thread and the batch; transient
failures (``TransientFault``, ``OSError``, timeouts) are retried
``worker_retries`` times; a pipeline that hands over nothing for
``timeout`` seconds raises with the stalled worker -> batch map.  The
``loader_stall``/``loader_error`` sites of the fault plan (``faults.py``)
exercise both.

Shards and the cursor: ``num_shards``/``shard_index`` give batch ``i`` to
shard ``i % num_shards``; ``num_shards="dist"`` reads
``torch.distributed`` at each ``__iter__`` when a process group is
initialized, else (1, 0).  ``state_dict()`` is the position cursor
(epoch, batches consumed, shard count, global position);
``load_state_dict()`` fast-forwards the next epoch to that global
position under the current shards, without building the skipped batches.

The device stage (``device_prefetch`` or ``MXTPU_DEVICE_PREFETCH``, 0 is
off) is PyTorch's idiom for the JAX package's async ``device_put``: with
``pin_memory=True`` the workers build each batch in pinned host memory
(MXNet's meaning of the flag; without a card it is a no-op); the stage
copies it to the consumer's current context with ``non_blocking=True`` on
a side ``torch.cuda.Stream`` and records an event there, keeps ``depth``
batches in flight beyond the one it yields, and before yielding a batch
makes the consumer's stream wait on that event and ``record_stream``s
its tensors on the consumer's stream, so the caching allocator does not
hand their memory to another copy while the step still reads it.
``set_device_put_fn`` replaces the copy (called on the side stream).

Metrics, in the registry under the JAX package's names: histograms
``loader.batch_build_us``, ``loader.consume_wait_us`` and
``loader.device_put_us`` (microseconds), counters ``loader.batches`` and
``loader.worker_retries``, gauges ``loader.prefetch_depth``,
``loader.prefetch_capacity`` and ``loader.device_buffer_depth``;
``consume_trace()`` drains the consumer's wait since the last call.  The
three histograms are ``observability.trace`` spans, as in the JAX package,
so a batch build, a consumer wait and a device put also land on
``mx.profiler``'s timeline and, inside a traced region, in the trace.
"""
from __future__ import annotations

import collections
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as _np
import torch

from ...base import MXNetError, get_env
from ...context import as_device, cpu
from ...faults import TransientFault, active_plan, retry_call
from ...ndarray import NDArray, array as nd_array
from ...observability.registry import registry as _metrics_registry
from ...observability.trace import span as _span
from .sampler import BatchSampler, RandomSampler, SequentialSampler

# worker failures worth retrying: injected faults and flaky I/O; a broken
# dataset (IndexError, bad shapes) surfaces at once
_RETRYABLE_WORKER_ERRORS = (TransientFault, OSError, TimeoutError,
                            ConnectionError)

__all__ = ["DataLoader", "default_batchify_fn", "default_device_put",
           "set_prefetch_override", "prefetch_override",
           "set_device_prefetch_override", "device_prefetch_override"]

# process-wide prefetch-depth override, applied at each loader's next
# __iter__ in place of its constructor value
_prefetch_override: Optional[int] = None


def set_prefetch_override(depth: Optional[int]) -> None:
    """Set (or clear, with None) the prefetch depth every loader takes at
    its next ``__iter__``."""
    global _prefetch_override
    _prefetch_override = None if depth is None else max(1, int(depth))


def prefetch_override() -> Optional[int]:
    return _prefetch_override


_device_prefetch_override: Optional[int] = None


def set_device_prefetch_override(depth: Optional[int]) -> None:
    """Set (or clear, with None) the device-stage depth every loader takes
    at its next ``__iter__`` (0 turns the stage off)."""
    global _device_prefetch_override
    _device_prefetch_override = None if depth is None \
        else max(0, int(depth))


def device_prefetch_override() -> Optional[int]:
    return _device_prefetch_override


def _leaves(batch):
    if isinstance(batch, (tuple, list)):
        for b in batch:
            yield from _leaves(b)
    elif isinstance(batch, NDArray):
        yield batch._data
    elif isinstance(batch, torch.Tensor):
        yield batch


def default_device_put(batch, ctx=None):
    """Leaf-wise copy of a host batch onto ``ctx`` (the current context if
    None): ``NDArray`` and tensor leaves with ``non_blocking=True``, numpy
    leaves through ``nd.array``, tuples recurse.  On the current stream;
    the device stage calls it under its side stream."""
    dev = as_device(ctx)
    if isinstance(batch, (tuple, list)):
        return tuple(default_device_put(b, dev) for b in batch)
    if isinstance(batch, NDArray):
        return NDArray(batch._data.to(dev, non_blocking=True))
    if isinstance(batch, torch.Tensor):
        return batch.to(dev, non_blocking=True)
    return nd_array(batch, ctx=dev)


class _WorkerError:
    """Carries a worker exception across the prefetch queue so that it
    re-raises in the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc


def _stack(tensors, pin: bool) -> torch.Tensor:
    first = tensors[0]
    shape = (len(tensors),) + tuple(first.shape)
    dtype = torch.float32 if first.dtype == torch.float64 else first.dtype
    out = torch.empty(shape, dtype=dtype, pin_memory=pin)
    torch.stack([t.to(dtype) for t in tensors], out=out)
    return out


def default_batchify_fn(data, pin_memory: bool = False):
    """Stack samples into a batch of CPU ``NDArray``s (NDArray, tensor or
    numpy leaves; tuples recurse; float64 becomes float32), in pinned
    memory when ``pin_memory`` and a card is present."""
    pin = pin_memory and torch.cuda.is_available()
    if isinstance(data[0], tuple):
        return tuple(default_batchify_fn(list(f), pin_memory)
                     for f in zip(*data))
    if isinstance(data[0], NDArray):
        return NDArray(_stack([d._data.cpu() for d in data], pin))
    if isinstance(data[0], torch.Tensor):
        return NDArray(_stack([d.cpu() for d in data], pin))
    arr = _np.asarray(data)
    if arr.dtype == _np.float64:
        arr = arr.astype(_np.float32)
    out = nd_array(arr, ctx=cpu())
    return NDArray(out._data.pin_memory()) if pin else out


def _pin(batch):
    """A batch from a user's batchify_fn with its CPU leaves pinned."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(_pin(b) for b in batch)
    if isinstance(batch, NDArray) and not batch._data.is_cuda:
        return NDArray(batch._data.pin_memory())
    if isinstance(batch, torch.Tensor) and not batch.is_cuda:
        return batch.pin_memory()
    return batch


class DataLoader:
    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, prefetch=None,
                 thread_pool=False, timeout=120, worker_retries=0,
                 num_shards=None, shard_index=None,
                 device_prefetch=None, device_put_fn=None):
        self._dataset = dataset
        if num_shards == "dist":
            if shard_index is not None:
                raise MXNetError(
                    "num_shards='dist' resolves shard_index from the "
                    "process group; don't pass both")
        elif num_shards is not None:
            num_shards = int(num_shards)
            shard_index = int(shard_index if shard_index is not None else 0)
            if not 0 <= shard_index < num_shards:
                raise MXNetError(
                    f"shard_index must be in [0, {num_shards}), got "
                    f"{shard_index}")
        elif shard_index is not None:
            raise MXNetError("shard_index requires num_shards")
        self._num_shards = num_shards
        self._shard_index = shard_index
        # position cursor: epoch (1-based once iteration starts), this
        # shard's batches consumed, the shard count, and the global base
        # the epoch (re)started from (global = base + consumed * shards)
        self._epoch = 0
        self._cursor_batch = 0
        self._cursor_shards = 1
        self._cursor_gbase = 0
        self._cursor_start = 0
        self._pending_state: Optional[dict] = None
        if batch_sampler is None:
            if batch_size is None:
                raise MXNetError("batch_size required when no batch_sampler")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle else \
                    SequentialSampler(len(dataset))
            elif shuffle:
                raise MXNetError("shuffle and sampler are exclusive")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        self._batch_sampler = batch_sampler
        self._pin_memory = bool(pin_memory)
        self._batchify_fn = batchify_fn
        self._num_workers = num_workers
        self._timeout = timeout
        self._worker_retries = max(0, int(worker_retries))
        self._prefetch = max(0, prefetch if prefetch is not None
                             else 2 * num_workers)
        self._device_prefetch = None if device_prefetch is None \
            else max(0, int(device_prefetch))
        self._device_put_fn = device_put_fn
        reg = _metrics_registry()
        self._c_batches = reg.counter(
            "loader.batches", help="batches built by the DataLoader")
        self._c_retries = reg.counter(
            "loader.worker_retries",
            help="transient worker failures retried")
        self._g_depth = reg.gauge(
            "loader.prefetch_depth",
            help="prefetch queue depth sampled at each batch handoff: "
                 "near capacity, the workers keep ahead of the step; "
                 "near zero, the pipeline starves it")
        self._g_capacity = reg.gauge(
            "loader.prefetch_capacity",
            help="prefetch queue capacity of the most recent __iter__")
        # the spans observe into these (registered here for their help)
        reg.histogram(
            "loader.batch_build_us",
            help="time a worker took to build one batch")
        reg.histogram(
            "loader.consume_wait_us",
            help="time the consumer blocked waiting for the next batch")
        reg.histogram(
            "loader.device_put_us",
            help="device stage: host time to enqueue one batch's copies "
                 "(the copies themselves run on the side stream)")
        self._g_device_depth = reg.gauge(
            "loader.device_buffer_depth",
            help="batches in flight on the device beyond the one being "
                 "consumed")
        self._trace_wait_us = 0.0
        self._trace_wait_end = 0.0
        self._trace_devput_us = 0.0

    def set_device_put_fn(self, fn) -> None:
        """Replace the device stage's copy of a batch (None restores
        ``default_device_put``); takes effect at the next __iter__."""
        self._device_put_fn = fn

    @property
    def device_put_fn(self):
        return self._device_put_fn

    def _resolve_device_depth(self) -> int:
        """The device stage's depth for the next epoch: the override, then
        the constructor value, then ``MXTPU_DEVICE_PREFETCH``."""
        if _device_prefetch_override is not None:
            return _device_prefetch_override
        if self._device_prefetch is not None:
            return self._device_prefetch
        return max(0, int(get_env("MXTPU_DEVICE_PREFETCH")))

    def _resolve_shard(self):
        """(num_shards, shard_index) for the next epoch."""
        if self._num_shards == "dist":
            import torch.distributed as dist
            if dist.is_available() and dist.is_initialized():
                return dist.get_world_size(), dist.get_rank()
            return 1, 0
        if self._num_shards is None:
            return 1, 0
        return self._num_shards, self._shard_index

    # -- position cursor ----------------------------------------------------
    def state_dict(self) -> dict:
        """The position cursor: ``global`` is the fleet-wide batch
        position, ``batch``/``num_shards`` this shard's local count."""
        consumed = self._cursor_batch - self._cursor_start
        return {"epoch": self._epoch,
                "batch": self._cursor_batch,
                "num_shards": self._cursor_shards,
                "global": self._cursor_gbase +
                consumed * self._cursor_shards}

    def load_state_dict(self, state: dict) -> None:
        """Restore a :meth:`state_dict` cursor at the next ``__iter__``:
        the epoch counter is restored and the epoch fast-forwards to the
        saved global position under the current shards.  (A cursor
        without ``global`` falls back to ``batch * num_shards``.)"""
        g = state.get("global")
        if g is None:
            g = int(state.get("batch", 0)) * \
                max(1, int(state.get("num_shards", 1)))
        self._pending_state = {
            "epoch": int(state.get("epoch", 0)),
            "global": int(g)}

    def _epoch_plan(self, num_shards, shard_index, start_batch):
        """(global_index, sample_indices) of this shard's batches this
        epoch, skipping the first ``start_batch`` unbuilt."""
        taken = 0
        for i, indices in enumerate(self._batch_sampler):
            if num_shards > 1 and i % num_shards != shard_index:
                continue
            taken += 1
            if taken <= start_batch:
                continue
            yield i, indices

    def __len__(self):
        n = len(self._batch_sampler)
        k, s = self._resolve_shard()
        if k <= 1:
            return n
        return len(range(s, n, k))

    def _make_batch(self, indices, batch_idx=None):
        # the batch id rides to the chrome-trace timeline as event args
        with _span("loader.batch_build_us",
                   args=None if batch_idx is None
                   else {"batch": batch_idx}):
            samples = [self._dataset[i] for i in indices]
            if self._batchify_fn is None:
                batch = default_batchify_fn(samples, self._pin_memory)
            else:
                batch = self._batchify_fn(samples)
                if self._pin_memory and torch.cuda.is_available():
                    batch = _pin(batch)
        self._c_batches.inc()
        return batch

    def _worker_batch(self, batch_idx, indices, active):
        """Build one batch in a worker thread: fault-plan sites, bounded
        retry on transient failures, and an error naming this worker and
        batch on the last failure."""
        worker = threading.current_thread().name
        active[worker] = batch_idx
        attempts = [0]
        try:
            plan = active_plan()
            if plan is not None:
                stall = plan.scheduled("loader_stall", batch_idx + 1)
                if stall is not None:
                    time.sleep(stall.arg if stall.arg is not None else 30.0)

            def attempt():
                attempts[0] += 1
                if plan is not None:
                    plan.fire("loader_error", batch_idx + 1)
                return self._make_batch(indices, batch_idx)

            def on_retry(attempt_no, exc, delay):
                self._c_retries.inc()

            try:
                return retry_call(attempt, retries=self._worker_retries,
                                  base_delay=0.02, max_delay=1.0,
                                  retry_on=_RETRYABLE_WORKER_ERRORS,
                                  on_retry=on_retry)
            except Exception as exc:
                raise MXNetError(
                    f"DataLoader worker {worker!r} failed on batch "
                    f"{batch_idx} after {attempts[0]} attempt(s): "
                    f"{exc!r}") from exc
        finally:
            active.pop(worker, None)

    def __iter__(self):
        k, s = self._resolve_shard()
        start_batch = 0
        gbase = 0
        if self._pending_state is not None:
            pending = self._pending_state
            self._pending_state = None
            self._epoch = pending["epoch"]
            # global batches [0, G) are consumed fleet-wide; this shard
            # owns those = shard_index (mod k): G//k of them, one more when
            # its index falls inside the G%k remainder
            gbase = pending["global"]
            start_batch = gbase // k + (1 if gbase % k > s else 0)
        else:
            self._epoch += 1
        self._cursor_shards = k
        self._cursor_gbase = gbase
        self._cursor_start = start_batch
        self._cursor_batch = start_batch
        plan = self._epoch_plan(k, s, start_batch)
        if self._num_workers == 0:
            src = (self._make_batch(indices, bi) for bi, indices in plan)
        else:
            src = self._threaded_iter(plan)
        depth = self._resolve_device_depth()
        if depth > 0:
            src = self._device_stage(src, depth)
        # the cursor counts batches handed to the consumer, so batches
        # still in the device stage are not counted and a resume replays
        # them
        try:
            while True:
                with _span("loader.consume_wait_us") as sp:
                    try:
                        batch = next(src)
                    except StopIteration:
                        break
                self._trace_wait_us += sp.duration_us
                self._trace_wait_end = sp.t_end * 1e6
                self._cursor_batch += 1
                yield batch
        finally:
            src.close()

    def consume_trace(self) -> dict:
        """Drain the consumer's wait since the last call: ``wait_us`` (time
        blocked in the loader), ``wait_end`` (``time.perf_counter()`` in
        microseconds at the last wait's end) and ``device_put_us`` (the
        device stage's enqueue time inside that wait)."""
        out = {"wait_us": self._trace_wait_us,
               "wait_end": self._trace_wait_end,
               "device_put_us": self._trace_devput_us}
        self._trace_wait_us = 0.0
        self._trace_devput_us = 0.0
        return out

    def _device_stage(self, src, depth: int):
        """Copy each host batch to the consumer's device on a side stream
        and keep ``depth`` batches in flight beyond the one yielded (see
        the module docstring)."""
        put = self._device_put_fn or default_device_put
        dev = as_device(None)
        side = torch.cuda.Stream(device=dev) if dev.type == "cuda" else None
        buf = collections.deque()

        def ready(placed, event):
            if event is not None:
                consumer = torch.cuda.current_stream(dev)
                consumer.wait_event(event)
                for t in _leaves(placed):
                    if t.is_cuda:
                        t.record_stream(consumer)
            return placed

        try:
            for item in src:
                with _span("loader.device_put_us") as dsp:
                    if side is None:
                        placed, event = put(item), None
                    else:
                        with torch.cuda.stream(side):
                            placed = put(item)
                            event = torch.cuda.Event()
                            event.record(side)
                self._trace_devput_us += dsp.duration_us
                buf.append((placed, event))
                if len(buf) > depth:
                    self._g_device_depth.set(len(buf) - 1)
                    yield ready(*buf.popleft())
            while buf:
                self._g_device_depth.set(len(buf) - 1)
                yield ready(*buf.popleft())
        finally:
            close = getattr(src, "close", None)
            if close is not None:
                close()

    def _threaded_iter(self, plan):
        # a bounded in-flight window, so a slow consumer never has more
        # than num_workers + prefetch batches built ahead of it
        prefetch = _prefetch_override if _prefetch_override is not None \
            else (self._prefetch or 2)
        self._g_capacity.set(prefetch)
        q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        sentinel = object()
        window = self._num_workers + prefetch
        active: dict = {}   # worker thread name -> batch index in progress
        # set when the consumer drops the epoch iterator mid-epoch: the
        # producer then stops instead of blocking in q.put forever
        abandoned = threading.Event()

        def hand_over(item) -> bool:
            while not abandoned.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with ThreadPoolExecutor(self._num_workers) as pool:
                    inflight = collections.deque()
                    for i, idx in plan:
                        if abandoned.is_set():
                            return
                        inflight.append(pool.submit(
                            self._worker_batch, i, idx, active))
                        if len(inflight) >= window:
                            if not hand_over(inflight.popleft().result()):
                                return
                    while inflight:
                        if not hand_over(inflight.popleft().result()):
                            return
            except BaseException as exc:
                hand_over(_WorkerError(exc))
            finally:
                # a blocking hand-over: a consumer busy downstream may
                # leave the queue full right as the epoch ends
                hand_over(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        expected = 0
        try:
            while True:
                try:
                    item = q.get(timeout=self._timeout)
                except queue.Empty:
                    stuck = dict(active)
                    raise MXNetError(
                        f"DataLoader prefetch timed out after "
                        f"{self._timeout}s waiting for batch {expected}"
                        + (f"; stalled workers (worker -> batch): {stuck}"
                           if stuck else "; no worker is active: the "
                           "producer thread may have died")) from None
                if item is sentinel:
                    break
                if isinstance(item, _WorkerError):
                    raise item.exc
                self._g_depth.set(q.qsize())
                yield item
                expected += 1
        finally:
            abandoned.set()
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
