"""Gluon Parameter / ParameterDict over ``torch.nn.Parameter``.

Counterpart of ``mxnet_tpu/gluon/parameter.py``.  A :class:`Parameter`
keeps MXNet's prefixed name (``bertmodel0_enc_..._qkv_weight``) and owns one
``nn.Parameter`` for its whole life: initialisation and loading replace
that tensor's ``.data`` in place, so every module that registered it (a
tied weight is registered by two) sees the change, and a weight shared by
two blocks gets one gradient.

The public surface is MXNet's (``mxnet_tpu/gluon/parameter.py:137-213``):
``data()``, ``list_data()``, ``grad()`` and ``list_grad()`` return
``NDArray``s over the parameter's storage, so ``p.data()[:] = x`` is what
the next forward reads, and ``grad()`` reads the buffer the latest
backward wrote (it looks the buffer up at each use); ``list_ctx()`` gives
the one context, ``var()`` a ``Symbol`` variable of the parameter's name
and shape.  The port's layers read the ``nn.Parameter`` itself through
``_tensor()`` and its gradient through ``_grad_tensor()``.

Deferred initialization (MXNet's, as ``mxnet_tpu/gluon/parameter.py``
:50-125 runs it): a parameter made with ``allow_deferred_init=True`` may
have 0 (unknown) dimensions.  ``initialize()`` then records the
initializer, the device and the generator and fills nothing; the layer's
first forward infers the shape from its input (``Block.infer_shape``) and
``_finish_deferred_init`` fills the data, on the CPU from the recorded
generator, then moves it to the device.  ``set_data`` on such a parameter
(``load_reference_params``) takes the shape from the array.  The data is
installed into the same ``nn.Parameter`` (``.data`` replaced with a tensor
of the new shape), so a ``Trainer`` built before the first forward, a tied
weight, ``state_dict()`` and the gradient hook all see the resolved tensor.
``data()`` before the shape is known raises
:class:`DeferredInitializationError`.

Seeds: ``ParameterDict.initialize(seed=)`` (``Block.initialize``) draws the
parameters of known shape one after another from one generator seeded with
``seed``, in ``collect_params()`` order, and gives each deferred parameter
a generator of its own, seeded from ``(seed, its index in that order)``.  A deferred draw thus depends on neither the
forward order nor the device, and one seed gives the same weights on any
device.

Gradients follow MXNet's ``grad_req``:

- ``"null"``: no gradient; the tensor has ``requires_grad=False``;
- ``"add"``: every backward adds into ``grad()`` until ``zero_grad()``;
- ``"write"`` (the default): every backward pass overwrites ``grad()``.
  PyTorch always accumulates into ``.grad``, so a hook on the tensor drops
  the old gradient when the first contribution of a new backward pass
  arrives (one pass is one autograd graph task; PyTorch sums the
  contributions of one pass before the hook sees them).

``fresh`` is the staleness flag of the JAX package's ``AGInfo``: True from
initialisation, ``zero_grad()`` and each optimizer update until a backward
writes the gradient.  ``gluon.Trainer`` refuses to apply a ``write``
gradient that is still fresh.

``cast(dtype)`` (MXNet's ``Parameter.cast``, used by ``Block.cast``)
records the dtype and replaces the data with a cast copy on its device,
inside the same ``nn.Parameter``: the modules that registered it, a
``Trainer``'s parameter list and a ``CachedGraph`` all see the new tensor.
``set_data`` takes numpy arrays of any dtype, the JAX package's bfloat16
(``ml_dtypes``) included, by their bits.

Storage epochs: every ``_set`` (initialisation, ``set_data``, ``cast``,
``load_reference_params``) and every ``grad_req`` change gives the
parameter a new ``epoch``, drawn from one process-wide counter
(``last_epoch()`` is its latest value).  A hybridized block's captured
graph reads its parameters at the addresses they had at capture time, so
it records the epochs it was captured at and is dropped when one moves on
(``gluon/block.py``); in-place updates (``Trainer.step``, BatchNorm's
running statistics) keep the storage and the epoch, and so does a value
set into a parameter that keeps its storage (``keep_storage``: a
recurrent layer's weights, views of one cuDNN buffer), which is copied in.

``Constant`` (``mxnet_tpu/gluon/parameter.py:218``) holds a value and
takes no gradient.  ``ParameterDict`` has the reference's
``zero_grad``, ``reset_ctx``, ``setattr`` (``.setattr("wd_mult", 0.0)``
on a ``collect_params(select)``), and ``save(strip_prefix=)``/
``load(allow_missing=, ignore_extra=, restore_prefix=)`` by full name in
``nd.save``'s format (:317-352), so a file of either package loads in
the other; a loaded value goes in through ``set_data``.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from .. import initializer as init_mod
from ..base import MXNetError, torch_dtype
from ..context import Context, DeviceLike, as_device, context_of
from ..ndarray.ndarray import NDArray

__all__ = ["Parameter", "Constant", "ParameterDict",
           "DeferredInitializationError"]

_GRAD_REQS = ("write", "add", "null")
_epoch_lock = threading.Lock()
_last_epoch = 0


def _next_epoch() -> int:
    global _last_epoch
    with _epoch_lock:
        _last_epoch += 1
        return _last_epoch


def last_epoch() -> int:
    """The newest storage epoch handed to any parameter."""
    return _last_epoch


_stand_ins = threading.local()


class standing_in:
    """While open in this thread, ``_tensor()`` of a parameter in
    ``aliases`` (``{id(param): tensor}``) returns its stand-in: a
    CUDA-graph capture (``gluon/cached_op.py``) runs the forward on leaves
    of its own that share the parameters' storage, so that the captured
    backward reaches no parameter's gradient accumulator or hook."""

    def __init__(self, aliases: Dict[int, torch.Tensor]):
        self._aliases = aliases

    def __enter__(self):
        self._prev = getattr(_stand_ins, "map", None)
        _stand_ins.map = self._aliases

    def __exit__(self, *exc):
        _stand_ins.map = self._prev


class DeferredInitializationError(MXNetError):
    """Parameter data asked for before its shape is known."""


def _deferred_generator(seed: int, index: int) -> torch.Generator:
    """The generator of the deferred parameter at ``index`` (in
    ``collect_params()`` order) of a block initialized with ``seed``."""
    state = np.random.SeedSequence([seed & (2 ** 64 - 1), index])
    return torch.Generator().manual_seed(
        int(state.generate_state(1, np.uint64)[0]) >> 1)


class Parameter:
    """A named weight with its initializer, ``grad_req``, lr/wd
    multipliers and one ``nn.Parameter``."""

    def __init__(self, name: str, grad_req: str = "write", shape=None,
                 dtype="float32", lr_mult: float = 1.0,
                 wd_mult: float = 1.0, init=None,
                 allow_deferred_init: bool = False):
        self.name = name
        if isinstance(shape, int):
            shape = (shape,)
        self.shape = tuple(shape or ())
        if not self.shape or (not allow_deferred_init
                              and not self.shape_known()):
            raise MXNetError(
                f"Parameter {name!r} needs a known shape, got {shape}; "
                f"give in_units/in_channels")
        self.dtype = torch_dtype(dtype)
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self.fresh = True
        self._initialized = False
        self._grad_task = None
        self._hooked = False
        self._deferred = None   # (init, device, generator) until resolved
        self.keeps_storage = False
        self.epoch = _next_epoch()
        self._data = nn.Parameter(
            torch.empty(self.shape if self.shape_known() else (0,),
                        dtype=self.dtype), requires_grad=False)
        self._grad_req = "null"
        self.grad_req = grad_req

    @property
    def grad_req(self) -> str:
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req: str) -> None:
        if req not in _GRAD_REQS:
            raise MXNetError(f"grad_req must be one of {_GRAD_REQS}, "
                             f"got {req!r}")
        self._grad_req = req
        self.epoch = _next_epoch()
        self._data.requires_grad_(req != "null")
        if req == "null":
            self._data.grad = None
        elif not self._hooked:
            self._data.register_hook(self._on_grad)
            self._hooked = True

    def _on_grad(self, grad):
        """Tensor hook, run once per backward pass that reaches this
        parameter, before PyTorch accumulates ``grad`` into ``.grad``."""
        task = torch._C._current_graph_task_id()
        if self._grad_req == "write" and (self.fresh
                                          or task != self._grad_task):
            self._data.grad = None
        self._grad_task = task
        self.fresh = False

    def shape_known(self) -> bool:
        return all(s > 0 for s in self.shape)

    def initialize(self, init=None, ctx: DeviceLike = None,
                   generator: Optional[torch.Generator] = None,
                   force_reinit: bool = False) -> None:
        """Fill on the CPU from ``generator`` (the parameter's own
        initializer wins over ``init``), then move to ``ctx``; with the
        shape still unknown, record the three for the first forward."""
        if self._initialized and not force_reinit:
            return
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        if not self.shape_known():
            self._deferred = (init, as_device(ctx), generator)
            return
        self._init_impl(init, as_device(ctx), generator)

    def _init_impl(self, init, device: torch.device,
                   generator: torch.Generator) -> None:
        host = torch.empty(self.shape, dtype=self.dtype)
        if self.init is not None:
            init_mod.create(self.init).init_weight(self.name, host, generator)
        else:
            init_mod.create(init)(self.name, host, generator)
        self._set(host.to(device))

    def _finish_deferred_init(self, inferred_shape) -> None:
        """Merge ``inferred_shape`` into the unknown dimensions (a known
        one must agree) and fill the data as ``initialize`` recorded it
        (nothing to fill before ``initialize``)."""
        inferred = tuple(int(s) for s in inferred_shape)
        if not self.accepts_shape(inferred):
            raise MXNetError(
                f"Parameter {self.name!r} of shape {self.shape} cannot "
                f"take the inferred shape {inferred}")
        self.shape = inferred
        if self._deferred is None:
            return
        init, device, generator = self._deferred
        self._deferred = None
        self._init_impl(init, device, generator)

    def _set(self, value: torch.Tensor) -> None:
        """Install ``value`` as the data; the old gradient is dropped
        (``grad()`` reads zeros) and is stale until a backward writes it.
        A parameter that keeps its storage (``keep_storage``) takes a
        value of its shape, dtype and device by a copy into it, and its
        epoch stays."""
        self._data.grad = None
        self.fresh = True
        cur = self._data
        if self._initialized and self.keeps_storage and \
                value.shape == cur.shape and value.dtype == cur.dtype and \
                value.device == cur.device:
            with torch.no_grad():
                cur.copy_(value)
            return
        self._data.data = value
        self._initialized = True
        self.keeps_storage = False
        self.epoch = _next_epoch()

    def keep_storage(self) -> None:
        """The storage under the data was replaced in place (a recurrent
        layer's parameters made views of one buffer for cuDNN,
        ``gluon/rnn/rnn_layer.py``): a new epoch, and from now on values of
        the same shape, dtype and device are copied into that storage
        (``set_data``, ``load_parameters``), so the buffer stays whole."""
        self.keeps_storage = True
        self.epoch = _next_epoch()

    def cast(self, dtype) -> None:
        """Cast to ``dtype`` (MXNet's ``Parameter.cast``): an initialized
        parameter gets a cast copy of its data on the same device, keeps
        its ``grad_req`` and drops its gradient (stale until a backward
        writes one); one not yet initialized only records the dtype."""
        self.dtype = torch_dtype(dtype)
        if self._initialized:
            self._set(self._data.detach().to(self.dtype, copy=True))

    def _tensor(self) -> nn.Parameter:
        """The data as the port's layers read it: the ``nn.Parameter``
        (its stand-in while a capture runs, ``standing_in``)."""
        if not self._initialized:
            if self._deferred is not None:
                raise DeferredInitializationError(
                    f"Parameter {self.name!r} awaits shape inference; run "
                    f"a forward pass first")
            raise MXNetError(f"Parameter {self.name!r} has not been "
                             f"initialized; call .initialize()")
        aliases = getattr(_stand_ins, "map", None)
        if aliases is not None:
            return aliases.get(id(self), self._data)
        return self._data

    def _grad_tensor(self) -> torch.Tensor:
        """The gradient buffer (zeros before the first backward)."""
        data = self._tensor()
        if self._grad_req == "null":
            raise MXNetError(
                f"Parameter {self.name!r} has grad_req='null'; no gradient")
        if data.grad is None:
            data.grad = torch.zeros_like(data)
        return data.grad

    def _check_ctx(self, ctx) -> None:
        if ctx is not None and as_device(ctx) != self._data.device:
            raise MXNetError(
                f"Parameter {self.name!r} not initialized on {ctx}; it "
                f"lives on {context_of(self._data.device)}")

    def data(self, ctx: DeviceLike = None) -> NDArray:
        """The data as an ``NDArray`` over the parameter's storage: a write
        into it (``data()[:] = x``) is what the next forward reads."""
        data = self._tensor()
        self._check_ctx(ctx)
        return NDArray(data)

    def list_data(self) -> List[NDArray]:
        return [self.data()]

    def list_ctx(self) -> List[Context]:
        self._tensor()
        return [context_of(self._data.device)]

    def grad(self, ctx: DeviceLike = None) -> NDArray:
        """The gradient buffer as an ``NDArray`` (zeros before the first
        backward) that reads the buffer at every use: after the next
        backward it holds that backward's gradient."""
        self._grad_tensor()
        self._check_ctx(ctx)
        return _GradArray(self)

    def list_grad(self) -> List[NDArray]:
        return [self.grad()]

    def var(self):
        """A ``Symbol`` variable of this parameter's name and shape."""
        from ..symbol import Symbol
        return Symbol.var(self.name, shape=self.shape)

    def zero_grad(self) -> None:
        if self._grad_req == "null" or not self._initialized:
            return
        if self._data.grad is not None:
            self._data.grad.zero_()
        self.fresh = True

    @property
    def device(self) -> torch.device:
        return self._data.device

    def accepts_shape(self, shape) -> bool:
        """Whether data of ``shape`` fits: every known dimension agrees
        (an unknown one takes any size)."""
        shape = tuple(shape)
        return len(shape) == len(self.shape) and all(
            s in (0, t) for s, t in zip(self.shape, shape))

    def set_data(self, value, ctx: DeviceLike = None) -> None:
        """Copy ``value`` (numpy or tensor) in, in this parameter's dtype,
        onto ``ctx``; without ``ctx`` an initialized parameter keeps its
        device, a deferred one goes where ``initialize`` said, and one
        never initialized to the default context.  A shape still unknown
        is taken from ``value``."""
        if isinstance(value, NDArray):
            value = value._data
        src = value if isinstance(value, torch.Tensor) \
            else _from_numpy(np.asarray(value))
        if not self.accepts_shape(src.shape):
            raise MXNetError(
                f"cannot set Parameter {self.name!r} of shape {self.shape} "
                f"with data of shape {tuple(src.shape)}")
        if ctx is not None:
            dev = as_device(ctx)
        elif self._initialized:
            dev = self._data.device
        elif self._deferred is not None:
            dev = self._deferred[1]
        else:
            dev = as_device(None)
        self.shape = tuple(src.shape)
        self._deferred = None
        self._set(src.detach().to(device=dev, dtype=self.dtype, copy=True))

    def reset_ctx(self, ctx: DeviceLike) -> None:
        """Move the data to ``ctx`` (MXNet's ``reset_ctx`` on one
        device); a deferred parameter goes there when its shape is
        known."""
        if self._deferred is not None:
            init, _, generator = self._deferred
            self._deferred = (init, as_device(ctx), generator)
            return
        if not self._initialized:
            raise MXNetError(f"Parameter {self.name!r} has not been "
                             f"initialized; call .initialize()")
        self._set(self._data.detach().to(as_device(ctx), copy=True))

    def __repr__(self):
        return (f"Parameter {self.name} (shape={self.shape}, "
                f"dtype={self.dtype})")


class _GradArray(NDArray):
    """``Parameter.grad()``: an ``NDArray`` whose tensor is the
    parameter's gradient buffer as it is at each use.  A ``"write"``
    backward may hand its gradient over as a new tensor (the parameter's
    hook drops the old one, ``Parameter._on_grad``), so the array looks
    it up instead of holding one."""

    __slots__ = ("_param",)

    def __init__(self, param: "Parameter"):
        self._param = param

    @property
    def _data(self) -> torch.Tensor:
        return self._param._grad_tensor()


class _ConstantInit(init_mod.Initializer):
    def __init__(self, value: np.ndarray):
        self.value = value

    def init_weight(self, name, arr, generator):
        arr.copy_(_from_numpy(self.value))


class Constant(Parameter):
    """A parameter that holds ``value`` and takes no gradient (MXNet's
    ``gluon.Constant``); a value that is not a numpy array becomes a
    float32 one."""

    def __init__(self, name: str, value):
        if not isinstance(value, np.ndarray):
            value = np.asarray(value, dtype=np.float32)
        self.value = value
        super().__init__(name, grad_req="null", shape=value.shape,
                         dtype=value.dtype, init=_ConstantInit(value))


def _from_numpy(arr: np.ndarray) -> torch.Tensor:
    """A CPU tensor copy of ``arr``; a bfloat16 array (``ml_dtypes``, which
    numpy knows only as 2-byte records) is carried over by its bits."""
    if arr.dtype.name == "bfloat16" and arr.dtype.itemsize == 2:
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16)
                                .copy()).view(torch.bfloat16)
    return torch.tensor(arr)


class ParameterDict:
    """Ordered name -> Parameter mapping with prefix namespacing."""

    def __init__(self, prefix: str = "",
                 shared: Optional["ParameterDict"] = None):
        self._prefix = prefix
        self._params: Dict[str, Parameter] = {}
        self._shared = shared

    @property
    def prefix(self) -> str:
        return self._prefix

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def __contains__(self, name):
        return name in self._params

    def __getitem__(self, name) -> Parameter:
        return self._params[name]

    def get(self, name: str, **kwargs) -> Parameter:
        """Fetch-or-create ``prefix + name`` (the Block's param entry)."""
        full = self._prefix + name
        if full in self._params:
            return self._params[full]
        if self._shared is not None and full in self._shared:
            param = self._shared[full]
        else:
            param = Parameter(full, **kwargs)
        self._params[full] = param
        return param

    def update(self, other: "ParameterDict") -> None:
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise MXNetError(f"duplicate parameter name {k!r}")
            self._params[k] = v

    def zero_grad(self) -> None:
        for p in self._params.values():
            p.zero_grad()

    def reset_ctx(self, ctx: DeviceLike) -> None:
        for p in self._params.values():
            p.reset_ctx(ctx)

    def setattr(self, name: str, value) -> None:
        """Set attribute ``name`` (``lr_mult``, ``wd_mult``,
        ``grad_req``) of every parameter to ``value``."""
        for p in self._params.values():
            setattr(p, name, value)

    def save(self, fname: str, strip_prefix: str = "") -> None:
        """``nd.save`` of every parameter's data by its name, less
        ``strip_prefix`` where the name starts with it."""
        from ..ndarray import utils as nd_utils
        arrays = {}
        for name, p in self._params.items():
            if strip_prefix and name.startswith(strip_prefix):
                name = name[len(strip_prefix):]
            arrays[name] = p._tensor().detach()
        nd_utils.save(fname, arrays)

    def load(self, fname: str, ctx: DeviceLike = None,
             allow_missing: bool = False, ignore_extra: bool = False,
             restore_prefix: str = "") -> None:
        """Set the parameters from an ``nd.save`` file (names prefixed
        with ``restore_prefix``), onto ``ctx`` if given; a parameter
        missing from the file raises unless ``allow_missing``, a name
        the dict lacks unless ``ignore_extra``."""
        from ..ndarray import utils as nd_utils
        loaded = nd_utils.load(fname, ctx="cpu")
        loaded = {restore_prefix + k: v for k, v in loaded.items()}
        if not allow_missing:
            for name in self._params:
                if name not in loaded:
                    raise MXNetError(f"parameter {name!r} missing from "
                                     f"{fname}")
        for name, val in loaded.items():
            if name not in self._params:
                if ignore_extra:
                    continue
                raise MXNetError(f"{fname} has unknown parameter {name!r}")
            self._params[name].set_data(val._data, ctx)

    def initialize(self, init=None, ctx: DeviceLike = None,
                   generator: Optional[torch.Generator] = None,
                   force_reinit: bool = False, seed: int = 0) -> None:
        """Initialize every parameter: those of known shape one after
        another from ``generator`` (default: seeded with ``seed``), each
        deferred one from a generator of its own, seeded from ``seed`` and
        its index."""
        if generator is None:
            generator = torch.Generator().manual_seed(seed)
        for i, p in enumerate(self._params.values()):
            gen = generator if p.shape_known() \
                else _deferred_generator(seed, i)
            p.initialize(init, ctx, gen, force_reinit)
