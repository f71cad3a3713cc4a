"""Gluon Block / HybridBlock as ``torch.nn.Module``s.

Counterpart of ``mxnet_tpu/gluon/block.py``.  A Block keeps MXNet's naming
(``name_scope`` prefixes, ``collect_params()`` keys such as
``bertmodel0_enc_layers_transformer_encoder_cell0_attn_qkv_weight``) and is
an ``nn.Module`` underneath: its weights are registered with the module,
so ``parameters()`` and ``state_dict()`` see them under their attribute
paths.  The port's layers write ``forward`` directly in torch ops: that
is the eager path and the one ``hybridize()`` captures.

Symbolic mode (``mxnet_tpu/gluon/block.py:324-329``): a ``HybridBlock``
called on a ``Symbol`` runs its ``hybrid_forward(F, x, *args, **params)``
with ``F = mxnet_tpu_torch.symbol`` and each registered parameter as its
``Parameter.var()``, and returns the ``Symbol`` of its output; a container
passes the ``Symbol`` down to its children, so a model called on
``mx.sym.var("data")`` gives its whole graph, op for op the JAX
package's.  The port's layers and the vision zoo's blocks keep a
``hybrid_forward`` beside their torch ``forward`` for that (the JAX
package's bodies); a block without one raises ``MXNetError`` naming
itself.  ``export(path, epoch)`` writes that graph and every parameter
(``path-symbol.json``, ``path-%04d.params`` with ``arg:`` keys, as the
JAX package's ``mxnet_tpu/gluon/block.py:666-681``), and
``SymbolBlock.imports`` loads such a pair (:749-782) and runs it through
the symbol executor.

``hybrid_forward`` (``mxnet_tpu/gluon/block.py:320-352``, :495-501): a
``HybridBlock`` subclass that defines ``hybrid_forward(self, F, x, *args,
**params)`` and no ``forward`` is called as MXNet calls it.  ``F`` is the
op namespace (``mxnet_tpu_torch.nd``), the inputs arrive as ``NDArray``s
over the caller's tensors and ``params`` holds the block's registered
parameters by their short names, as ``NDArray``s over the parameters'
tensors (no copy; autograd reaches the parameters through them).  Inside
it the ``NDArray`` ops record exactly when torch's grad mode is on, so a
block called on tensors inside a model, under ``autograd.record()`` or
inside a capture differentiates as a tensor ``forward`` would.  Its
outputs go back to the caller as tensors (and, through ``Block.__call__``,
as ``NDArray``s to a caller that passed ``NDArray``s); ``hybridize()``
and deferred shapes treat it as any other forward.

Layers whose behaviour depends on the mode (Dropout, BatchNorm) follow
MXNet's global ``autograd.is_training()``, which is on only inside
``autograd.record()``/``train_mode()``; ``nn.Module.training`` is not
consulted (``train()``/``eval()`` change nothing).  Place a model with
``initialize(ctx=...)``; moving it with ``nn.Module.to`` is not supported,
because a Parameter shared by two modules must move once, in place.

Called with ``NDArray`` inputs, a block runs on their tensors (under
``torch.no_grad()`` outside ``autograd.record()``, as MXNet records only
inside it) and returns ``NDArray``s; called with tensors it returns
tensors, as the layers inside a model call each other.

Deferred shape inference (``mxnet_tpu/gluon/block.py:315-350``): a layer
built without its input width (``Dense(in_units=0)``, ``Conv2D`` or
``BatchNorm`` without ``in_channels``) holds parameters with unknown
dimensions.  At its first call, before ``forward``, the block's
``infer_shape(*inputs)`` fixes them from the input and finishes their
deferred initialization (``Parameter._finish_deferred_init``); one eager
pass thus settles every deferred shape of a model, children in the order
they run.  A block with unknown shapes and no ``infer_shape`` raises
``MXNetError``.

``hybridize()`` is MXNet's CachedOp, as the JAX package has it
(``mxnet_tpu/gluon/block.py:302-500``): the outermost active block keeps
one entry per input signature in an LRU of ``CACHED_GRAPH_LIMIT`` (32),
``_cached_graph``, with the JAX package's ``cache_info()`` and its one
``RuntimeWarning`` once it starts evicting; its children are set inactive
and run inside its forward.  The key is the inputs' structure (keyword
names, which optional inputs are None), shapes and dtypes,
``autograd.is_training()``, the device and the AMP target dtype; within
an entry, a recording call (``autograd.is_recording()`` and a parameter
or input that takes a gradient) and a plain call each have their graph,
as the JAX entry holds a jit and a jitted vjp.  On the card an entry
warms with one eager call and then replays CUDA graphs of the forward
and, when recording, the backward (``gluon/cached_op.py``); on the CPU
its callable is the eager forward.  While a parameter's shape is unknown
the call runs eagerly.  ``cast(dtype)`` casts every parameter of the
block and its children (MXNet's ``Block.cast``) and drops the cache; an
entry whose parameters' storage moved (``Parameter.epoch``: ``set_data``,
``load_reference_params``) is dropped at its next call and captured
again.  A block whose forward reads the host (``reads_host``, Mask-RCNN's
NMS) cannot be captured: ``hybridize()`` warns once and its calls run
eagerly, counted in ``eager_calls``.  A hybridized call outside
``record()`` records no autograd node, as in the JAX package.

``cached_graph(*examples)`` is the serving entry: a :class:`CachedGraph`
whose ``raw(*arrays)`` copies host arrays into the signature's captured
inputs, replays its inference graph and returns fresh device tensors.
``cached_graph(*examples, entry="prefill"|"decode")`` does the same for a
block's generation entry, ``hybrid_<entry>`` (the JAX package's
``mxnet_tpu/gluon/block.py:503-640``): one graph per call (a prefill
graph per prompt bucket, one decode graph), its device inputs and the
state it returns (the KV pool) carried in place (``gluon/cached_op.py``).
Such a graph holds the caller's state, so the handle owns it: it stays
out of the LRU, and dropping the handle frees it.

``collect_params(select)`` keeps the parameters whose name the regular
expression matches from its start, as the reference's ``re.match``.
``save_parameters``/``load_parameters`` (``mxnet_tpu/gluon/block.py:
174-200``) name each parameter by its attribute path (``0.weight``) in
``nd.save``'s format, so a file of either package loads in the other;
``load_parameters`` falls back to fully prefixed names and raises the
reference's errors on a missing or an unknown name.
"""
from __future__ import annotations

import collections
import re
import threading
import warnings
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree
from torch import nn

from .. import autograd
from ..base import MXNetError
from ..context import DeviceLike
from ..contrib.amp import amp as _amp
from ..ndarray.ndarray import NDArray
from ..ndarray.register import call_on_tensors, has_ndarray, unwrap, wrap
from . import cached_op
from ..symbol.symbol import Group, Symbol
from .parameter import Parameter, ParameterDict

__all__ = ["Block", "HybridBlock", "CachedGraph", "SymbolBlock"]

_naming_counter_lock = threading.Lock()
_naming_counters: Dict[str, int] = {}


def _gen_prefix(hint: str) -> str:
    with _naming_counter_lock:
        idx = _naming_counters.get(hint, 0)
        _naming_counters[hint] = idx + 1
    return f"{hint}{idx}_"


def _strip(name: str, prefix: str) -> str:
    return name[len(prefix):] if name.startswith(prefix) else name


def _camel_to_snake(name: str) -> str:
    return re.sub("([a-z0-9])([A-Z])", r"\1_\2", name).lower()


class _BlockScope:
    """Prefix scoping: blocks created inside ``with parent.name_scope():``
    get the parent's prefix prepended (the MXNet name manager)."""

    _current = threading.local()

    def __init__(self, block: "Block"):
        self._block = block
        self._counters: Dict[str, int] = {}

    @staticmethod
    def create(prefix: Optional[str], params, hint: str):
        """The block's prefix and its ParameterDict.  Given ``params``
        (another block's ``.params``), the dict takes that dict's prefix
        and shares its parameters, as MXNet's name manager does: a
        ``Dense(..., params=embedding.params)`` ties its weight to the
        embedding's (the JAX package keeps the block's own prefix, so
        nothing is shared unless the prefixes agree)."""
        cur = getattr(_BlockScope._current, "value", None)
        if cur is None:
            if prefix is None:
                prefix = _gen_prefix(hint)
            return prefix, ParameterDict(
                params.prefix if params is not None else prefix, params)
        if prefix is None:
            idx = cur._counters.get(hint, 0)
            cur._counters[hint] = idx + 1
            prefix = f"{hint}{idx}_"
        full = cur._block.prefix + prefix
        if params is not None:
            return full, ParameterDict(params.prefix, params)
        return full, ParameterDict(full, cur._block._params._shared)

    def __enter__(self):
        self._old = getattr(_BlockScope._current, "value", None)
        _BlockScope._current.value = self
        return self

    def __exit__(self, *exc):
        _BlockScope._current.value = self._old


class Block(nn.Module):
    """Base building block (MXNet ``gluon.Block``) over ``nn.Module``."""

    def __init__(self, prefix: Optional[str] = None, params=None):
        super().__init__()
        hint = _camel_to_snake(type(self).__name__)
        self._prefix, self._params = _BlockScope.create(prefix, params, hint)
        self._scope = _BlockScope(self)
        self._reg_params: Dict[str, Parameter] = {}
        self._deferred_shapes = False
        self.training = False

    def __call__(self, *args, **kwargs):
        if any(isinstance(a, Symbol) for a in args):
            return self._symbol_call(*args, **kwargs)
        if self._deferred_shapes:
            self._deferred_infer(*args)
        if not has_ndarray(args, kwargs):
            return self._forward_call(*args, **kwargs)
        return call_on_tensors(self._forward_call, args, kwargs)

    def _forward_call(self, *args, **kwargs):
        """The call on tensors: the forward itself (a hybridized block
        goes through its cache first)."""
        return nn.Module.__call__(self, *args, **kwargs)

    def _symbol_call(self, *args, **kwargs):
        """The call on ``Symbol``s: a plain block's ``forward`` (a
        ``Sequential`` runs its children on them)."""
        return self.forward(*args, **kwargs)

    def __setattr__(self, name, value):
        if isinstance(value, Parameter):
            # attribute lookup returns the MXNet Parameter; nn.Module sees
            # its tensor (shared tensors are deduplicated by parameters())
            self._reg_params[name] = value
            self._parameters[name] = value._data
            object.__setattr__(self, name, value)
            if not value.shape_known():
                object.__setattr__(self, "_deferred_shapes", True)
            return
        super().__setattr__(name, value)

    def register_forward_hook(self, hook, **kwargs):
        """Call ``hook(block, args, out)`` after each forward, with the
        inputs and outputs as ``NDArray``s (MXNet's and the JAX package's
        signature, ``mxnet_tpu/gluon/block.py:217``); returns the handle
        whose ``remove()`` takes it off."""
        def call(module, args, out):
            return hook(module, wrap(tuple(args)), wrap(out))
        return super().register_forward_hook(call, **kwargs)

    def summary(self, *inputs):
        """Run the block on ``inputs``, print its parameter count (the
        JAX package's ``Block.summary``, :223) and return the output."""
        out = self(*inputs)
        total = sum(int(np.prod(p.shape)) for p in
                    self.collect_params().values())
        print(f"{type(self).__name__}: {total} parameters")
        return out

    def infer_shape(self, *args) -> None:
        """Fix the unknown dimensions of this block's parameters from its
        inputs (``Parameter._finish_deferred_init``); layers with deferred
        parameters override it."""
        raise MXNetError(
            f"{type(self).__name__} has uninitialized parameters with "
            f"unknown shape and no infer_shape; give explicit in_units/"
            f"in_channels")

    def _deferred_infer(self, *args) -> None:
        """Settle this block's unknown shapes from its first inputs (a
        shared parameter another block settled needs nothing)."""
        params = self._reg_params.values()
        if not all(p.shape_known() for p in params):
            self.infer_shape(*args)
            if not all(p.shape_known() for p in params):
                raise MXNetError(f"{type(self).__name__}.infer_shape left "
                                 f"a shape unknown")
        object.__setattr__(self, "_deferred_shapes", False)

    @property
    def prefix(self) -> str:
        return self._prefix

    @property
    def name(self) -> str:
        return self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix

    @property
    def params(self) -> ParameterDict:
        return self._params

    def name_scope(self) -> _BlockScope:
        return self._scope

    def register_child(self, block: "Block",
                       name: Optional[str] = None) -> None:
        self.add_module(name or str(len(self._modules)), block)

    def collect_params(self, select: Optional[str] = None) -> ParameterDict:
        """This block's parameters and its children's, by full name; with
        ``select``, those whose name the regular expression matches from
        its start (``".*gamma|.*beta|.*bias"``)."""
        ret = ParameterDict(self._params.prefix)
        if select is None:
            ret.update(self._params)
        else:
            pat = re.compile(select)
            for name, p in self._params.items():
                if pat.match(name):
                    ret._params[name] = p
        for child in self._modules.values():
            if isinstance(child, Block):
                for k, v in child.collect_params(select).items():
                    ret._params[k] = v
        return ret

    def _collect_params_with_prefix(self, prefix: str = "") \
            -> Dict[str, Parameter]:
        """Parameters by attribute path (``0.weight``, ``features.3.
        running_mean``): ``save_parameters``' names, which do not depend
        on the process's name counters."""
        if prefix:
            prefix += "."
        ret = {prefix + key: p for key, p in self._reg_params.items()}
        for name, child in self._modules.items():
            if isinstance(child, Block):
                ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    def save_parameters(self, filename: str,
                        deduplicate: bool = False) -> None:
        """``nd.save`` of every parameter by its attribute path (MXNet's
        ``Block.save_parameters``); with ``deduplicate`` a parameter
        shared by several blocks is written once, under its first
        path."""
        from ..ndarray import utils as nd_utils
        params = self._collect_params_with_prefix()
        if deduplicate:
            seen = set()
            params = {k: p for k, p in params.items()
                      if id(p) not in seen and not seen.add(id(p))}
        nd_utils.save(filename, {name: p._tensor().detach()
                                 for name, p in params.items()})

    def load_parameters(self, filename: str, ctx: DeviceLike = None,
                        allow_missing: bool = False,
                        ignore_extra: bool = False, cast_dtype: bool = False,
                        dtype_source: str = "current") -> None:
        """Set the parameters from a ``save_parameters`` file of either
        package (a file of fully prefixed names, as ``ParameterDict.save``
        writes, is matched by name less this block's prefix).  Each value
        goes in through ``Parameter.set_data``, in the parameter's dtype
        (``cast_dtype`` with ``dtype_source="saved"`` casts the parameter
        to the file's dtype first), onto ``ctx`` if given; a hybridized
        block's graphs then capture again."""
        from ..ndarray import utils as nd_utils
        loaded = nd_utils.load(filename, ctx="cpu")
        params = self._collect_params_with_prefix()
        if loaded and params and not any(k in params for k in loaded):
            full = self.collect_params()
            loaded = {_strip(k, self.prefix): v for k, v in loaded.items()}
            params = {_strip(k, self.prefix): p for k, p in full.items()}
        for name, arr in loaded.items():
            if name not in params:
                if ignore_extra:
                    continue
                raise MXNetError(f"{filename} contains unknown parameter "
                                 f"{name!r}")
            p = params[name]
            if cast_dtype and dtype_source == "saved":
                p.cast(arr.dtype)
            p.set_data(arr._data, ctx)
        if not allow_missing:
            for name in params:
                if name not in loaded:
                    raise MXNetError(f"parameter {name!r} missing from "
                                     f"{filename}")

    save_params = save_parameters
    load_params = load_parameters

    def initialize(self, init=None, ctx: DeviceLike = None,
                   force_reinit: bool = False, seed: int = 0) -> None:
        """Initialize every parameter from ``seed`` and place it on
        ``ctx`` (default ``gpu(0)``): those of known shape from one
        ``torch.Generator`` in ``collect_params()`` order, the deferred
        ones at the first forward, each from its own generator
        (``ParameterDict.initialize``)."""
        self.collect_params().initialize(init, ctx, None, force_reinit,
                                         seed=seed)

    def hybridize(self, active: bool = True, **kwargs) -> None:
        for child in self._modules.values():
            if isinstance(child, Block):
                child.hybridize(active, **kwargs)

    def cast(self, dtype) -> None:
        """Cast the parameters of this block and of its children to
        ``dtype`` (``Parameter.cast``)."""
        for child in self._modules.values():
            if isinstance(child, Block):
                child.cast(dtype)
        for p in self._params.values():
            p.cast(dtype)

    def device(self) -> torch.device:
        """Where this block's parameters live (CPU for a block without
        parameters)."""
        for p in self.collect_params().values():
            return p.device
        return torch.device("cpu")




class _BoundedCache:
    """Tiny LRU with the ``functools.lru_cache`` info surface (a copy of
    the JAX package's, ``mxnet_tpu/ndarray/register.py:41-90``).

    Eviction drops the last reference to an entry, and with it its CUDA
    graphs and their memory pools."""

    __slots__ = ("maxsize", "_d", "hits", "misses")

    def __init__(self, maxsize: int):
        self.maxsize = maxsize
        self._d = collections.OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, key, default=None):
        d = self._d
        try:
            val = d[key]
            d.move_to_end(key)
        except KeyError:
            # a miss, or a concurrent eviction raced the move_to_end
            self.misses += 1
            return default
        self.hits += 1
        return val

    def put(self, key, val) -> None:
        d = self._d
        d[key] = val
        try:
            d.move_to_end(key)
            if len(d) > self.maxsize:
                d.popitem(last=False)
        except KeyError:
            pass                      # concurrent eviction: already gone

    def values(self):
        return list(self._d.values())

    def cache_info(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "maxsize": self.maxsize, "currsize": len(self._d)}

    def cache_clear(self) -> None:
        self._d.clear()
        self.hits = 0
        self.misses = 0


def _leaf_key(x):
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.dtype)
    try:
        hash(x)
    except TypeError:
        raise MXNetError(f"a hybridized block takes tensors, None and "
                         f"hashable constants, not {type(x).__name__}")
    return (type(x).__name__, x)


class HybridBlock(Block):
    """A Block whose forward ``hybridize()`` turns into cached graphs, one
    per input signature (see the module docstring)."""

    #: cached graphs kept per block (distinct input signatures), LRU-evicted
    #: beyond this, as in the JAX package: each entry pins its graphs'
    #: memory pools.
    CACHED_GRAPH_LIMIT = 32

    #: a block whose forward reads device values back to the host (a
    #: data-dependent shape, ``.tolist()``) cannot be captured into a CUDA
    #: graph; ``hybridize()`` on it warns once and its calls run eagerly,
    #: counted in ``eager_calls``
    reads_host = False

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False
        self._cached_graph = _BoundedCache(self.CACHED_GRAPH_LIMIT)
        self._recompile_warned = False
        self._host_warned = False
        self.eager_calls = 0

    def hybridize(self, active: bool = True, static_alloc: bool = False,
                  static_shape: bool = False, inline_limit: int = 2,
                  **kwargs) -> None:
        """Reset the cache and set every child inactive: only the outermost
        active block captures, its children run inside its graph.  The
        other arguments are MXNet's and change nothing here: every
        signature is captured with its memory held (``static_alloc``) and
        keyed by its shapes (``static_shape``)."""
        self._active = active
        self._cached_graph = _BoundedCache(self.CACHED_GRAPH_LIMIT)
        if active and self.reads_host:
            self._warn_host("")
        super().hybridize(False, **kwargs)

    def _warn_host(self, why: str) -> None:
        if self._host_warned:
            return
        self._host_warned = True
        warnings.warn(
            f"HybridBlock {self.name!r} ({type(self).__name__}) reads "
            f"the host in its forward{why} and cannot be captured into a "
            f"CUDA graph; its hybridized calls run eagerly (counted in "
            f"eager_calls)", RuntimeWarning, stacklevel=3)

    def found_host_read(self, op: str) -> None:
        """An eager call of this hybridized block read the host (``op``,
        see ``ndarray.register.host_read``): from now on it is treated as
        a block that sets ``reads_host``: one warning, then every call
        runs eagerly, counted in ``eager_calls``."""
        self.reads_host = True
        self._cached_graph = _BoundedCache(self.CACHED_GRAPH_LIMIT)
        self._warn_host(f" ({op})")

    def cast(self, dtype) -> None:
        self._cached_graph = _BoundedCache(self.CACHED_GRAPH_LIMIT)
        super().cast(dtype)

    def forward(self, *args, **kwargs):
        """MXNet's dispatch to ``hybrid_forward(F, *inputs, **params)``
        (see the module docstring); a subclass that writes ``forward``
        itself replaces it."""
        from .. import ndarray as F
        params = {k: NDArray(p._tensor())
                  for k, p in self._reg_params.items()}
        with autograd._RecordingScope(torch.is_grad_enabled(), None):
            out = self.hybrid_forward(F, *_to_nd(args), **_to_nd(kwargs),
                                      **params)
        return unwrap(out)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError(
            f"{type(self).__name__} defines neither forward nor "
            f"hybrid_forward")

    def _symbol_call(self, x, *args, **kwargs):
        """``hybrid_forward`` with ``F = symbol`` and the parameters as
        their ``var()``s (``mxnet_tpu/gluon/block.py:324-329``)."""
        if type(self).hybrid_forward is HybridBlock.hybrid_forward:
            raise MXNetError(
                f"{type(self).__name__} has no symbolic body "
                f"(hybrid_forward) and cannot be called on a Symbol")
        from .. import symbol as F
        params = {k: p.var() for k, p in self._reg_params.items()}
        return self.hybrid_forward(F, x, *args, **kwargs, **params)

    def export(self, path: str, epoch: int = 0) -> Tuple[str, str]:
        """Write this block's graph on one input ``data`` to
        ``path-symbol.json`` and every parameter's data to
        ``path-%04d.params`` under ``arg:<name>`` (BatchNorm's running
        statistics too: they are arguments of the graph, as in the JAX
        package); returns the two paths."""
        from ..ndarray import utils as nd_utils
        out = self(Symbol.var("data"))
        sym_file = f"{path}-symbol.json"
        out.save(sym_file)
        params_file = f"{path}-{epoch:04d}.params"
        nd_utils.save(params_file, {
            f"arg:{name}": p._tensor().detach()
            for name, p in self.collect_params().items()})
        return sym_file, params_file

    def _forward_call(self, *args, **kwargs):
        if not self._active or cached_op.inline():
            return nn.Module.__call__(self, *args, **kwargs)
        if self.reads_host:
            self.eager_calls += 1
            return nn.Module.__call__(self, *args, **kwargs)
        leaves, spec = pytree.tree_flatten((args, kwargs))
        entry = self._entry(leaves, spec, autograd.is_training())
        recording = autograd.is_recording() and torch.is_grad_enabled() \
            and (entry.takes_grad() or any(
                isinstance(x, torch.Tensor) and x.requires_grad
                for x in leaves))
        return entry(leaves, spec, recording)

    def _signature(self, leaves, spec, training: bool):
        """The cache key: the inputs' structure (keyword names and which
        optional inputs are None), shapes and dtypes, training mode, the
        device and the AMP target dtype."""
        device = next((x.device for x in leaves
                       if isinstance(x, torch.Tensor)), None)
        if device is None:
            device = self.device()
        return (spec, tuple(_leaf_key(x) for x in leaves), training,
                device, _amp._target())

    def _entry(self, leaves, spec, training: bool) -> cached_op.CachedOp:
        """The entry of this signature: made on a miss (with the JAX
        package's one warning once the cache starts evicting), and made
        anew, as warm as it was, when its parameters' storage moved."""
        sig = self._signature(leaves, spec, training)
        cached = self._cached_graph.get(sig)
        if cached is not None and not cached.stale():
            return cached
        device = sig[3]
        fresh = cached_op.CachedOp(self, device, cached.warm if cached
                                   else ())
        evicting = cached is None and (
            self._cached_graph.cache_info()["currsize"]
            >= self.CACHED_GRAPH_LIMIT)
        self._cached_graph.put(sig, fresh)
        if evicting and not self._recompile_warned:
            self._recompile_warned = True
            warnings.warn(
                f"HybridBlock {self.name!r} compiled more than "
                f"{self.CACHED_GRAPH_LIMIT} distinct input "
                "signatures; oldest executables are now LRU-"
                "evicted (recompile storm — consider bucketing "
                "input shapes or raising CACHED_GRAPH_LIMIT)",
                RuntimeWarning, stacklevel=4)
        return fresh

    def graph_stats(self) -> dict:
        """The cache's entries, their graphs (mode, replays, capture ms,
        pool bytes) and their eager calls (the warm call of each mode on
        the card, the calls before every shape was known, and the calls
        on the CPU), and ``eager_calls``, a host-reading block's
        hybridized calls."""
        entries = [e.stats() for e in self._cached_graph.values()]

        def total(key):
            return sum(e[key] for e in entries)
        return {"entries": len(entries),
                "graphs": sum(len(e["graphs"]) for e in entries),
                "replays": sum(g["replays"] for e in entries
                               for g in e["graphs"]),
                "warm_calls": total("warm_calls"),
                "deferred_calls": total("deferred_calls"),
                "cpu_calls": total("cpu_calls"),
                "eager_calls": self.eager_calls, "by_entry": entries,
                "cache": self._cached_graph.cache_info()}

    def _inference_entry(self, args, warmed: bool = False,
                         own: Optional[cached_op.CachedOp] = None
                         ) -> cached_op.CachedOp:
        """The entry of ``args`` in predict mode, its inference graph
        captured on the card (after a warm eager call, unless ``warmed``
        says one just ran): the cache's entry, or ``own``, an entry that
        its :class:`CachedGraph` holds outside the cache."""
        with autograd.pause(), cached_op._capture_lock:
            leaves, spec = pytree.tree_flatten((tuple(args), {}))
            entry = own if own is not None else \
                self._entry(leaves, spec, False)
            mode = ("infer",)
            if entry.device.type == "cuda" and entry.settled() and \
                    mode not in entry.graphs:
                if warmed:
                    entry.warm.add(mode)
                elif mode not in entry.warm:
                    entry(leaves, spec, False)
                entry.capture(mode, leaves, spec)
        return entry

    def cached_graph(self, *examples, entry: str = "forward"
                     ) -> "CachedGraph":
        """Freeze one inference signature for serving: one call on
        ``examples`` (host arrays or tensors whose shapes and dtypes
        define the signature), which settles deferred shapes and builds
        the kernels, then, on the card, the signature's inference graph
        captured into the same cache ``hybridize()`` fills, whether or not
        the block is hybridized.  ``entry`` names the method: ``"forward"``
        or a generation entry the block implements, ``"prefill"``
        (``hybrid_prefill``) or ``"decode"`` (``hybrid_decode``), whose
        first call is its warm call, eager, on ``examples`` (pass tables
        that point at scratch: its writes land there), and whose state is
        carried in place (the module docstring).  A generation entry's
        graph captures the caller's state tensor, so it is held by the
        returned handle alone, never by the block's cache: dropping the
        handle frees the graph and its hold on the state.  Raises
        ``AttributeError`` for an entry the block lacks.  Returns the
        :class:`CachedGraph`."""
        dev = self.device()
        if entry != "forward" and not callable(
                getattr(self, "hybrid_" + entry, None)):
            raise AttributeError(
                f"{type(self).__name__} has no hybrid_{entry}(); a "
                f"generation-servable block implements hybrid_prefill and "
                f"hybrid_decode (see gluon.model_zoo.transformer.CausalLM)")
        args = [_as_input(v, dev) for v in examples]
        with torch.no_grad(), autograd.predict_mode():
            if entry == "forward":
                self(*args)
                op = self._inference_entry(args, warmed=True)
            else:
                op = self._inference_entry(
                    args, own=cached_op.CachedOp(self, dev, (), entry))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return CachedGraph(self, op, dev, entry)


def _to_nd(x):
    """Tensors (alone, in lists, tuples and dicts) as ``NDArray``s over
    them."""
    if isinstance(x, torch.Tensor):
        return NDArray(x)
    if isinstance(x, (list, tuple)):
        return type(x)(_to_nd(v) for v in x)
    if isinstance(x, dict):
        return {k: _to_nd(v) for k, v in x.items()}
    return x


def _as_input(v, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(v if isinstance(v, torch.Tensor)
                           else np.asarray(v), device=device)


class CachedGraph:
    """Inference-only handle over one signature of a block, the entry the
    serving dispatch calls once per batch.

    ``raw(*arrays)`` copies host arrays (or tensors) into the signature's
    captured inputs, replays its graph and returns fresh device tensors,
    without synchronising.  Threads may call it at once: each graph's
    static buffers are held from the copy in to the copy out, and a
    replay on another stream waits for the previous one.  Arrays of
    another signature, or parameters whose storage moved since (``cast``,
    ``set_data``), resolve the block's entry again (a capture).  On the
    CPU it runs the forward eagerly, as the block's entry does there.
    Each calling thread enters ``torch.inference_mode()`` and predict
    mode itself (they are thread-local).  A generation entry's
    ``raw(tokens, ..., pool)`` returns ``(logits, pool)``: the pool it was
    given, updated in place."""

    __slots__ = ("_block", "_entry", "device", "entry")

    def __init__(self, block: HybridBlock, entry: cached_op.CachedOp,
                 device: torch.device, entry_name: str = "forward"):
        self._block = block
        self._entry = entry
        self.device = device
        self.entry = entry_name

    def raw(self, *values) -> Tuple[torch.Tensor, ...]:
        with torch.inference_mode(), autograd.predict_mode():
            if self.device.type != "cuda":
                args = [_as_input(v, self.device) for v in values]
                if self.entry == "forward":
                    out = self._block(*args)
                else:
                    out = self._entry(*pytree.tree_flatten(
                        (tuple(args), {})), False)
            else:
                host = [_as_input(v, None) if not isinstance(
                    v, torch.Tensor) else v for v in values]
                graph = self._graph(host)
                out = graph.run(host)
        return tuple(out) if isinstance(out, (tuple, list)) else (out,)

    def stats(self) -> dict:
        """The entry's calls and its graphs (``CachedOp.stats``): replays,
        capture ms, pool bytes, the bytes a replay copies out."""
        return self._entry.stats()

    def _graph(self, host):
        entry = self._entry
        graph = entry.graphs.get(("infer",))
        if graph is None or entry.stale() or any(
                _leaf_key(s) != _leaf_key(h)
                for s, h in zip(graph.static, host)):
            args = [h.to(self.device) for h in host]
            own = None if self.entry == "forward" else cached_op.CachedOp(
                self._block, self.device, (), self.entry)
            entry = self._entry = self._block._inference_entry(args,
                                                               own=own)
            graph = entry.graphs[("infer",)]
        return graph


class SymbolBlock(HybridBlock):
    """A block over a ``Symbol`` graph and its parameters (MXNet's
    ``gluon.SymbolBlock``; the JAX package's ``mxnet_tpu/gluon/block.py:
    749-782``): ``outputs`` the graph, ``inputs`` the variables the
    caller feeds, ``params`` a ``name -> NDArray`` dict of the rest.

    Each entry of ``params`` becomes a :class:`Parameter` of that name
    (``grad_req="null"``: the JAX package's imported arrays take no
    gradient) on the array's device; ``collect_params()`` lists them.
    ``forward`` feeds the inputs and the parameters' tensors to the graph
    and runs it through the symbol executor (``Symbol.compile``: the
    registry's ops on torch tensors), and returns one output, or a list
    of several.  It is a ``HybridBlock``, as MXNet's is (the JAX class is
    a plain ``Block``), so ``hybridize()`` and ``cached_graph()`` capture
    its forward into CUDA graphs on the card, as for any other block.
    Calling it on a ``Symbol`` raises (no symbolic body, as in the JAX
    package).  ``imports`` loads an ``export``ed pair."""

    def __init__(self, outputs, inputs, params=None):
        super().__init__(prefix="symbolblock_", params=None)
        if isinstance(outputs, (list, tuple)):
            outputs = Group(outputs)
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        self._input_names = [s.name for s in inputs]
        self._run = outputs.compile()
        for name, value in (params or {}).items():
            value = value._data if isinstance(value, NDArray) \
                else torch.as_tensor(np.asarray(value))
            p = Parameter(name, grad_req="null", shape=tuple(value.shape),
                          dtype=value.dtype)
            p.set_data(value, value.device)
            self._params._params[name] = p
            self._reg_params[name] = p
            # nn.Module's keys take no dots; MXNet's names may
            self._parameters[name.replace(".", "_")] = p._data

    @staticmethod
    def imports(symbol_file: str, input_names,
                param_file: Optional[str] = None,
                ctx: DeviceLike = None) -> "SymbolBlock":
        """A ``SymbolBlock`` over an exported pair: the graph of
        ``symbol_file``, ``input_names`` (a name or a list) as its inputs,
        and the arrays of ``param_file`` (``arg:``/``aux:`` prefixes
        dropped) on ``ctx`` (the current context, ``gpu(0)`` unless the
        caller is in another)."""
        from ..ndarray import utils as nd_utils
        from ..symbol import load
        params = {}
        if param_file:
            for k, v in nd_utils.load(param_file, ctx=ctx).items():
                params[k.split(":", 1)[1] if ":" in k else k] = v
        if isinstance(input_names, str):
            input_names = [input_names]
        return SymbolBlock(load(symbol_file),
                           [Symbol.var(n) for n in input_names], params)

    def forward(self, *args):
        feed = dict(zip(self._input_names, args))
        for name, p in self._reg_params.items():
            feed[name] = p._tensor()
        outs = self._run(feed)
        return outs[0] if len(outs) == 1 else list(outs)
