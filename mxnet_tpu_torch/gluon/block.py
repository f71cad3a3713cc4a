"""Gluon Block / HybridBlock as ``torch.nn.Module``s.

Counterpart of ``mxnet_tpu/gluon/block.py``.  A Block keeps MXNet's naming
(``name_scope`` prefixes, ``collect_params()`` keys such as
``bertmodel0_enc_layers_transformer_encoder_cell0_attn_qkv_weight``) and is
an ``nn.Module`` underneath: its weights are registered with the module,
so ``parameters()`` and ``state_dict()`` see them under their attribute
paths.  Layers write ``forward`` directly in torch ops; there is no ``F``
namespace and no symbolic mode.

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

``hybridize()`` records the flag and nothing else: PyTorch runs eagerly,
in training as in inference.  ``cast(dtype)`` casts every parameter of
the block and its children (MXNet's ``Block.cast``); the JAX package's
``HybridBlock.cast`` also drops its cached graphs, and the port keeps
none to drop: a ``CachedGraph`` holds the block, so its next batch runs
on the cast parameters.
``cached_graph(*examples)`` is the serving entry: a :class:`CachedGraph`
whose ``raw(*arrays)`` copies host arrays to the block's device, runs the
forward under ``torch.inference_mode()`` and returns device tensors.
"""
from __future__ import annotations

import re
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .. import autograd
from ..base import MXNetError
from ..context import DeviceLike
from ..ndarray.ndarray import NDArray
from ..ndarray.register import call_on_tensors
from .parameter import Parameter, ParameterDict

__all__ = ["Block", "HybridBlock", "CachedGraph"]

_naming_counter_lock = threading.Lock()
_naming_counters: Dict[str, int] = {}


def _gen_prefix(hint: str) -> str:
    with _naming_counter_lock:
        idx = _naming_counters.get(hint, 0)
        _naming_counters[hint] = idx + 1
    return f"{hint}{idx}_"


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
        cur = getattr(_BlockScope._current, "value", None)
        if cur is None:
            if prefix is None:
                prefix = _gen_prefix(hint)
            return prefix, ParameterDict(prefix, params)
        if prefix is None:
            idx = cur._counters.get(hint, 0)
            cur._counters[hint] = idx + 1
            prefix = f"{hint}{idx}_"
        full = cur._block.prefix + prefix
        return full, ParameterDict(full, params if params is not None
                                   else cur._block._params._shared)

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
        if self._deferred_shapes:
            self._deferred_infer(*args)
        if not any(isinstance(a, NDArray) for a in args) and not any(
                isinstance(a, NDArray) for a in kwargs.values()):
            return nn.Module.__call__(self, *args, **kwargs)
        return call_on_tensors(
            lambda *a, **k: nn.Module.__call__(self, *a, **k), args, kwargs)

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

    def collect_params(self) -> ParameterDict:
        """This block's parameters and its children's, by full name."""
        ret = ParameterDict(self._params.prefix)
        ret.update(self._params)
        for child in self._modules.values():
            if isinstance(child, Block):
                for k, v in child.collect_params().items():
                    ret._params[k] = v
        return ret

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


class HybridBlock(Block):
    """A Block that can be frozen into a :class:`CachedGraph`."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False

    def hybridize(self, active: bool = True, **kwargs) -> None:
        self._active = active
        super().hybridize(active, **kwargs)

    def cached_graph(self, *examples) -> "CachedGraph":
        """Freeze one inference signature for serving: runs the forward
        once on ``examples`` (host arrays or tensors whose shapes and
        dtypes define the signature), which also builds any kernel the
        forward launches, and returns the :class:`CachedGraph`."""
        graph = CachedGraph(self, self.device())
        graph.raw(*examples)
        if graph.device.type == "cuda":
            torch.cuda.synchronize(graph.device)
        return graph


class CachedGraph:
    """Inference-only handle over one block, the entry the serving
    dispatch calls once per batch."""

    __slots__ = ("_block", "device")

    def __init__(self, block: HybridBlock, device: torch.device):
        self._block = block
        self.device = device

    def raw(self, *values) -> Tuple[torch.Tensor, ...]:
        """Host arrays (or tensors) in, tuple of device tensors out: one
        forward under ``torch.inference_mode()`` in predict mode, no
        synchronisation.  Each calling thread enters both modes itself
        (they are thread-local)."""
        with torch.inference_mode(), autograd.predict_mode():
            args = [torch.as_tensor(np.asarray(v) if not
                                    isinstance(v, torch.Tensor) else v,
                                    device=self.device) for v in values]
            out = self._block(*args)
        return tuple(out) if isinstance(out, (tuple, list)) else (out,)
