"""MXNet's CachedOp for the port: one cache entry per input signature of a
hybridized block, replayed from CUDA graphs on the card.

Counterpart of the JAX package's ``HybridBlock._call_cached`` /
``_build_cached`` (``mxnet_tpu/gluon/block.py:361-493``), where an entry
holds a ``jax.jit`` of the forward and a ``jax.jit(jax.vjp(...))`` for
recording calls.  Here ``torch.cuda.CUDAGraph`` stands in for ``jax.jit``
and a captured backward for the jitted vjp.

An entry (:class:`CachedOp`) is keyed by ``HybridBlock._signature`` and
holds up to one graph per *mode*: ``("infer",)`` for calls that do not
record, and ``("train", flags)`` for recording calls, ``flags`` saying
which inputs take a gradient.  On a CUDA device:

- the first call of a mode runs the block eagerly (the *warm* call: it
  builds the kernels, creates the cuBLAS handles and takes the shapes'
  first allocations, so that none of that happens under capture); its
  side effects are those of any call;
- the next call captures the mode's graph and replays it.  A recording
  mode captures the forward with autograd on and, in the same memory
  pool, ``torch.autograd.grad`` of its outputs with respect to every
  parameter that takes a gradient and every input that does; a replay is
  one ``torch.autograd.Function`` (:class:`_Replay`) whose forward
  replays the forward graph and whose backward replays the backward
  graph.  The captured forward reads leaves of its own that share the
  parameters' storage (``Parameter._tensor()`` returns them while it runs),
  and the backward graph computes the gradients with respect to those;
  the parameters themselves are inputs of the Function, so their
  gradients reach ``.grad`` through autograd as in an eager call, and
  their hooks (``grad_req``) run outside the graph;
- inputs are copied into the graph's static inputs; outputs and
  gradients are copied out (``torch._foreach_copy_``) into fresh tensors,
  so a later replay changes nothing a caller holds;
- the forward's in-place writes (BatchNorm's running statistics) are
  captured as writes into the parameters' storage;
- every port generator of the device is registered with the graph
  (``register_generator_state``; torch's default CUDA generator always
  is), so each replay draws fresh random numbers from the generator's
  current state, and a seeded run repeats;
- kernel launch counters (``kernels/counters.py``): what a capture
  launched is not counted; each replay adds it.

A graph keeps the addresses it was captured with: the parameters' storage
(``Parameter.epoch`` says when it was replaced, and the block then drops
the entry) and its own activations.  A recording replay's backward reads
the activations of the latest forward replay of its graph, so a second
forward of the same signature before the first one's backward makes the
first one's backward raise instead of returning wrong gradients.

A generation entry (``cached_graph(..., entry="prefill"|"decode")``,
which runs the block's ``hybrid_<entry>`` instead of its forward) carries
state in place: each of its inputs given as a tensor on the device is
captured as it is, never cloned, so a replay reads it where it lies and
copies nothing in for it; an output that is one of those inputs (the KV
pool the entry updates and returns) is handed back as it is, never copied
out.  Every graph captured on one pool thus updates that pool, and a
replay copies out only the other outputs (the logits).  A replay given
another tensor in a carried input's place raises ``MXNetError``; in
another captured input's place it is copied into the captured tensor.

A capture that fails raises ``MXNetError``, after taking the generators
out of capture; nothing falls back to eager.
On a CPU device an entry's callable is the eager forward: the cache, its
keys and its bookkeeping are the same, and no graph is made.
"""
from __future__ import annotations

import contextlib
import gc
import threading
import time
import weakref
from typing import Dict, List, Optional

import torch
import torch.utils._pytree as pytree
from torch import nn

from .. import random as _random
from ..base import MXNetError
from ..kernels import counters
from ..ndarray.register import host_reads
from . import parameter as _param

__all__ = ["CachedOp", "inline"]

_inline = threading.local()
# CUDA graphs are captured one at a time in a process
_capture_lock = threading.RLock()


def inline() -> bool:
    """Whether this thread is inside a cached call's forward, where nested
    hybridized blocks run as plain code (the JAX package's trace)."""
    return getattr(_inline, "depth", 0) > 0


@contextlib.contextmanager
def _running():
    _inline.depth = getattr(_inline, "depth", 0) + 1
    try:
        yield
    finally:
        _inline.depth -= 1


def _end_generator_capture(gens, device: torch.device) -> None:
    """Put the generators back out of capture after a capture failed.

    torch takes a registered generator out of capture mode only when a
    capture ends cleanly; one left in it refuses every later draw outside
    a graph ("Offset increment outside graph capture"), in this block and
    any other.  A one-op capture that succeeds, with the generators
    registered (torch's default CUDA generator always is), ends it and
    keeps each generator's seed and offset."""
    graph = torch.cuda.CUDAGraph()
    for gen in gens:
        graph.register_generator_state(gen)
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        torch.zeros(1, device=device)
    torch.cuda.synchronize(device)


class _Replay(torch.autograd.Function):
    """One recording replay: the forward graph, then, at backward, the
    backward graph.  Inputs: the graph, then the tensors that take a
    gradient (the parameters, then the inputs), whose gradients come back
    as fresh tensors."""

    @staticmethod
    def forward(ctx, graph, *targets):
        graph.fwd.replay()
        graph.generation += 1
        ctx.graph, ctx.generation = graph, graph.generation
        outs = graph.copy_out()
        ctx.mark_non_differentiable(
            *[outs[j] for j, i in enumerate(graph.out_tensors)
              if i not in graph.diff])
        return tuple(outs)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *gouts):
        graph = ctx.graph
        with graph.lock, torch.no_grad():
            if ctx.generation != graph.generation:
                raise MXNetError(
                    f"{graph.name}: a later call of this input signature "
                    f"replayed the captured forward before this call's "
                    f"backward, and the graph keeps one call's "
                    f"activations; call backward before the next forward "
                    f"of the signature")
            pos = {i: j for j, i in enumerate(graph.out_tensors)}
            torch._foreach_copy_(graph.gouts,
                                 [gouts[pos[i]] for i in graph.diff])
            graph.bwd.replay()
            counters.replay(graph.bwd_delta)
            live = [g for g in graph.grads if g is not None]
            fresh = [torch.empty_like(g) for g in live]
            torch._foreach_copy_(fresh, live)
        it = iter(fresh)
        return (None, *[None if g is None else next(it)
                        for g in graph.grads])


class _Graph:
    """The captured graph (or graphs, forward and backward) of one mode of
    a :class:`CachedOp`."""

    def __init__(self, name: str, device: torch.device, recording: bool):
        self.name = name
        self.device = device
        self.recording = recording
        self.fwd = torch.cuda.CUDAGraph()
        self.bwd = None
        self.static: list = []          # the inputs, flat
        self.outs: list = []            # the outputs, flat
        self.out_spec = None
        self.out_tensors: List[int] = []  # the outputs copied out
        self.carried: Dict[int, int] = {}  # output -> the input it is
        self.diff: List[int] = []       # outputs that take a gradient
        self.gouts: List[torch.Tensor] = []
        self.grads: list = []           # gradients of params, then inputs
        self.params: List[torch.Tensor] = []
        self.grad_inputs: List[int] = []
        self.fwd_delta: dict = {}
        self.bwd_delta: dict = {}
        self.generation = 0
        self.replays = 0
        self.capture_ms = 0.0
        self.pool_bytes = 0
        self.lock = threading.Lock()
        self.done: Optional[torch.cuda.Event] = None

    def copy_out(self) -> List[torch.Tensor]:
        src = [self.outs[i] for i in self.out_tensors]
        fresh = [torch.empty_like(t) for t in src]
        torch._foreach_copy_(fresh, src)
        return fresh

    def run(self, leaves):
        """Copy ``leaves`` in, replay, and return the outputs in the
        forward's structure (fresh tensors)."""
        stream = torch.cuda.current_stream(self.device)
        for j in self.carried.values():
            if leaves[j].data_ptr() != self.static[j].data_ptr():
                raise MXNetError(
                    f"{self.name}: input {j} is carried in place by the "
                    f"captured graph; pass the tensor it was captured "
                    f"with")
        with self.lock:
            if self.done is not None:     # a replay on another stream
                stream.wait_event(self.done)
            with torch.no_grad():
                for s, x in zip(self.static, leaves):
                    if isinstance(s, torch.Tensor) and \
                            s.data_ptr() != x.data_ptr():
                        s.copy_(x)
            if self.recording:
                targets = self.params + [leaves[i] for i in self.grad_inputs]
                outs = _Replay.apply(self, *targets)
            else:
                self.fwd.replay()
                with torch.no_grad():
                    outs = self.copy_out()
            counters.replay(self.fwd_delta)
            self.replays += 1
            if self.done is None:
                self.done = torch.cuda.Event()
            self.done.record(stream)
        flat = list(self.outs)
        for i, o in zip(self.out_tensors, outs):
            flat[i] = o
        for i, j in self.carried.items():
            flat[i] = leaves[j]
        return pytree.tree_unflatten(flat, self.out_spec)

    def stats(self) -> dict:
        """Mode, replays, capture ms, the pool's bytes, and the bytes a
        replay copies out (outputs, and gradients when recording; not the
        carried state)."""
        copied = [self.outs[i] for i in self.out_tensors] + \
            [g for g in self.grads if g is not None]
        return {"mode": "train" if self.recording else "infer",
                "replays": self.replays, "capture_ms": self.capture_ms,
                "pool_bytes": self.pool_bytes,
                "copy_bytes": sum(t.numel() * t.element_size()
                                  for t in copied)}


class CachedOp:
    """One input signature of a hybridized block: its parameters once
    every shape is known, the storage epoch they were read at, and a graph
    per mode (see the module docstring)."""

    def __init__(self, block, device: torch.device, warm=(),
                 entry: str = "forward"):
        # weak, so that dropping a block frees its graphs at once, not at
        # a later garbage collection that could fall inside a capture
        self._block = weakref.ref(block)
        self.device = device
        self.entry = entry          # "forward", or a generation entry
        self.params = None
        self.epoch = 0
        self._seen = -1
        self.warm = set(warm)
        self.graphs: Dict[tuple, _Graph] = {}
        self.warm_calls = 0         # a mode's first call on the card
        self.deferred_calls = 0     # calls while a shape is unknown
        self.cpu_calls = 0          # calls on the CPU, eager by design

    @property
    def block(self):
        return self._block()

    def settled(self) -> bool:
        """Whether every parameter has its shape and data (before that the
        calls run eagerly, as the JAX package's first call does)."""
        if self.params is None:
            ps = list(self.block.collect_params().values())
            if not all(p._initialized for p in ps):
                return False
            self.params = ps
            self.epoch = max((p.epoch for p in ps), default=0)
            self._seen = _param.last_epoch()
        return True

    def stale(self) -> bool:
        """Whether a parameter's storage or ``grad_req`` changed since the
        entry read them."""
        if self.params is None:
            return False
        now = _param.last_epoch()
        if now == self._seen:
            return False
        if max((p.epoch for p in self.params), default=0) != self.epoch:
            return True
        self._seen = now
        return False

    def takes_grad(self) -> bool:
        """Whether a parameter takes a gradient (its ``grad_req`` is known
        before its shape, so a deferred call under ``record()`` records)."""
        params = self.params if self.params is not None else \
            self.block.collect_params().values()
        return any(p._data.requires_grad for p in params)

    def _invoke(self, args, kwargs):
        """The block's forward, or its ``hybrid_<entry>`` method."""
        if self.entry == "forward":
            return nn.Module.__call__(self.block, *args, **kwargs)
        return getattr(self.block, "hybrid_" + self.entry)(*args, **kwargs)

    def eager(self, leaves, spec, recording: bool):
        """The block's forward run eagerly.  If it read values back to the
        host (an op that calls ``register.host_read``: ``boolean_mask``,
        ``bincount``, an unranged ``histogram``), the block is marked
        ``reads_host`` (``HybridBlock.found_host_read``), so no graph of
        it is ever captured."""
        args, kwargs = pytree.tree_unflatten(leaves, spec)
        reads = host_reads()[0]
        with _running(), torch.set_grad_enabled(recording):
            out = self._invoke(args, kwargs)
        count, name = host_reads()
        if count != reads:
            self.block.found_host_read(name)
        return out

    def __call__(self, leaves, spec, recording: bool):
        if not self.settled():
            self.deferred_calls += 1
            return self.eager(leaves, spec, recording)
        if self.device.type != "cuda":
            self.cpu_calls += 1
            return self.eager(leaves, spec, recording)
        mode = ("train", tuple(isinstance(x, torch.Tensor) and
                               x.requires_grad for x in leaves)) \
            if recording else ("infer",)
        if mode not in self.warm:
            self.warm_calls += 1
            out = self.eager(leaves, spec, recording)
            self.warm.add(mode)
            return out
        graph = self.graphs.get(mode)
        if graph is None:
            graph = self.capture(mode, leaves, spec)
        return graph.run(leaves)

    def capture(self, mode, leaves, spec) -> _Graph:
        """Capture ``mode``'s graph on ``leaves`` (see the module
        docstring); raises ``MXNetError`` if the forward cannot be
        captured."""
        recording = mode[0] == "train"
        dev = self.device
        graph = _Graph(self.block.name, dev, recording)
        with _capture_lock:
            existing = self.graphs.get(mode)
            if existing is not None:
                return existing
            in_place = self.entry != "forward"
            with torch.no_grad():
                graph.static = [
                    x if in_place and isinstance(x, torch.Tensor)
                    and x.device == dev else
                    x.detach().clone().requires_grad_(
                        recording and x.requires_grad)
                    if isinstance(x, torch.Tensor) else x for x in leaves]
            gens = [_random.generator(dev)]
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(dev)
            t0 = time.perf_counter()
            # a collection during the capture could free another graph
            # (cudaFree, which a capture does not allow)
            collecting = gc.isenabled()
            gc.disable()
            try:
                self._capture(graph, gens, spec, recording)
            except Exception as e:
                _end_generator_capture(gens, dev)
                raise MXNetError(
                    f"HybridBlock {self.block.name!r}: the forward could not "
                    f"be captured into a CUDA graph ({type(e).__name__}: "
                    f"{e}); a block whose forward reads values back to the "
                    f"host sets reads_host = True and runs eagerly") from e
            finally:
                if collecting:
                    gc.enable()
            torch.cuda.synchronize(dev)
            graph.capture_ms = (time.perf_counter() - t0) * 1e3
            graph.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
            self.graphs[mode] = graph
        return graph

    def _capture(self, graph: _Graph, gens, spec, recording: bool) -> None:
        args, kwargs = pytree.tree_unflatten(graph.static, spec)
        # the forward reads leaves of its own over the parameters' storage:
        # the parameters' gradient accumulators (made by eager calls, on
        # another stream) and hooks stay out of the captured backward
        aliases = {id(p): p._data.detach().requires_grad_(
            p._data.requires_grad) for p in self.params}
        for gen in gens:
            graph.fwd.register_generator_state(gen)
        with counters.recording() as delta:
            with torch.cuda.graph(graph.fwd, capture_error_mode="thread_local"):
                with _running(), torch.set_grad_enabled(recording), \
                        _param.standing_in(aliases):
                    out = self._invoke(args, kwargs)
            graph.fwd_delta = dict(delta)
            delta.clear()
            graph.outs, graph.out_spec = pytree.tree_flatten(out)
            static = {id(x): j for j, x in enumerate(graph.static)
                      if isinstance(x, torch.Tensor)}
            graph.carried = {i: static[id(o)] for i, o in
                             enumerate(graph.outs) if id(o) in static}
            graph.out_tensors = [i for i, o in enumerate(graph.outs)
                                 if isinstance(o, torch.Tensor)
                                 and i not in graph.carried]
            if not recording:
                return
            graph.diff = [i for i in graph.out_tensors
                          if graph.outs[i].requires_grad]
            if not graph.diff:          # nothing to differentiate
                graph.recording = False
                return
            takes = [p for p in self.params if p._data.requires_grad]
            graph.params = [p._data for p in takes]
            graph.grad_inputs = [i for i, x in enumerate(graph.static)
                                 if isinstance(x, torch.Tensor)
                                 and x.requires_grad]
            targets = [aliases[id(p)] for p in takes] + \
                [graph.static[i] for i in graph.grad_inputs]
            graph.gouts = [torch.zeros_like(graph.outs[i])
                           for i in graph.diff]
            graph.bwd = torch.cuda.CUDAGraph()
            for gen in gens:
                graph.bwd.register_generator_state(gen)
            with torch.cuda.graph(graph.bwd, pool=graph.fwd.pool(),
                                  capture_error_mode="thread_local"):
                graph.grads = list(torch.autograd.grad(
                    [graph.outs[i] for i in graph.diff], targets,
                    grad_outputs=graph.gouts, allow_unused=True))
            graph.bwd_delta = dict(delta)
            # the outputs keep no autograd graph: the captured backward
            # is the only backward of this mode
            graph.outs = [o.detach() if isinstance(o, torch.Tensor) else o
                          for o in graph.outs]

    def stats(self) -> dict:
        return {"warm_calls": self.warm_calls,
                "deferred_calls": self.deferred_calls,
                "cpu_calls": self.cpu_calls,
                "graphs": [g.stats() for g in self.graphs.values()]}
