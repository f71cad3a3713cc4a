"""NDArray: MXNet's mutable n-dimensional array, over a ``torch.Tensor``.

Counterpart of ``mxnet_tpu/ndarray/ndarray.py`` (``NDArray`` :66, the
constructors :579-660).  An ``NDArray`` holds one tensor (``_data``) in
the role the JAX ``NDArray`` gives its ``jax.Array``.  Torch tensors are
mutable and have views, so MXNet's aliasing is the tensor's own: a basic
slice (``x[1:3]``, ``x[0]``) and ``reshape`` are ``NDArray``s over torch
views, and ``x.reshape(...)[:] = v`` writes into ``x``.  The JAX
package's version counter, view specs and read cache (:66-160), which
rebuild that aliasing over immutable buffers, have no counterpart.
Integer-array and boolean-mask indexing copy, as in MXNet.  Ops return
new arrays: no registry op hands back a view of its input.

Reads and writes follow MXNet's recording rule: outside
``autograd.record()`` every method runs under ``torch.no_grad()``, so
``w[:] = w - lr * w.grad``, ``w -= ...`` and ``out=w`` work on an array
with a gradient; inside it, ops are recorded and an in-place write on an
array with a gradient raises (MXNet refuses it too).

Autograd state lives on the tensor: ``attach_grad(grad_req)`` makes the
array a fresh leaf (``detach().requires_grad_()``) with a zero gradient
buffer, which every backward overwrites (``"write"``) or adds to
(``"add"``), as in MXNet; ``grad`` is that buffer.  ``backward()`` on a
non-scalar head seeds ones.

``asnumpy()``/``asscalar()`` copy to the host (the sync points, counted
as host reads by ``engine.stats()``); a bfloat16 array comes back as
float32 (numpy has no bfloat16).  ``dtype`` is the numpy dtype (torch's
for bfloat16); ``context`` is a ``Context``.  The constructors default
to float32 (a float64 numpy array becomes float32, a Python list float32)
and to the current context (``gpu(0)`` unless a ``with cpu():`` scope is
open).
"""
from __future__ import annotations

import contextlib
import weakref
from typing import Optional, Tuple

import numpy as np
import torch

from .. import autograd as _ag
from ..base import MXNetError, torch_dtype
from ..context import Context, DeviceLike, as_device, context_of
from ..engine import engine as _engine_fn

__all__ = ["NDArray", "array", "zeros", "ones", "empty", "full", "arange",
           "eye", "linspace", "resolve_reshape"]

_engine = _engine_fn()
_GRAD_REQS = ("write", "add", "null")


def _np_dtype(dt: torch.dtype):
    try:
        return np.dtype(str(dt)[6:])
    except TypeError:
        return dt


def _grad_mode():
    """``no_grad`` outside ``autograd.record()``, else nothing."""
    return contextlib.nullcontext() if _ag.is_recording() else \
        torch.no_grad()


class _GradState:
    """``grad_req`` of an attached tensor, and the hook that makes a
    ``"write"`` gradient start from zero in every backward pass (torch
    accumulates into ``.grad``; the hook runs once per pass, before)."""

    __slots__ = ("req", "_ref")
    suppressed = 0          # autograd.grad: leave the buffers alone

    def __init__(self, tensor: torch.Tensor, req: str):
        self.req = req
        self._ref = weakref.ref(tensor)

    def __call__(self, grad):
        if self.req == "write" and not _GradState.suppressed:
            t = self._ref()
            if t is not None and t.grad is not None:
                t.grad.zero_()


def attach(t: torch.Tensor, grad_req: str = "write",
           grad: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A leaf over ``t``'s storage that takes gradients by ``grad_req``
    into ``grad`` (zeros if None); ``"null"`` gives a plain tensor."""
    if grad_req not in _GRAD_REQS:
        raise MXNetError(f"grad_req must be one of {_GRAD_REQS}, got "
                         f"{grad_req!r}")
    leaf = t.detach()
    if grad_req == "null":
        return leaf
    if not leaf.is_floating_point():
        raise MXNetError(f"attach_grad: a {leaf.dtype} array takes no "
                         f"gradient")
    leaf.requires_grad_()
    leaf.grad = torch.zeros_like(leaf) if grad is None else grad
    state = _GradState(leaf, grad_req)
    leaf._mx_grad = state
    leaf.register_hook(state)
    return leaf


def _index(key):
    """An index key with its arrays as tensors (float indices truncated,
    lists as arrays)."""
    if isinstance(key, tuple):
        return tuple(_index(k) for k in key)
    if isinstance(key, NDArray):
        key = key._data
    elif isinstance(key, (list, np.ndarray)):
        key = torch.as_tensor(np.asarray(key))
    if isinstance(key, torch.Tensor) and key.is_floating_point():
        key = key.long()
    return key


class NDArray:
    """Mutable n-dimensional array on a device (see the module
    docstring)."""

    __slots__ = ("_data", "__weakref__")
    # NDArray wins over numpy in mixed binary ops
    __array_priority__ = 1000.0

    def __init__(self, data: torch.Tensor):
        self._data = data

    # ------------------------------------------------------------ properties
    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return _np_dtype(self._data.dtype)

    @property
    def ndim(self) -> int:
        return self._data.dim()

    @property
    def size(self) -> int:
        return self._data.numel()

    @property
    def context(self) -> Context:
        return context_of(self._data.device)

    ctx = context

    @property
    def stype(self) -> str:
        return "default"

    @property
    def grad(self) -> Optional["NDArray"]:
        g = self._data.grad
        return None if g is None else NDArray(g)

    @property
    def grad_req(self) -> str:
        state = getattr(self._data, "_mx_grad", None)
        return "null" if state is None else state.req

    @property
    def T(self) -> "NDArray":
        return _reg.invoke_by_name("transpose", [self], {})

    def __repr__(self):
        return (f"\n{self.asnumpy()}\n<NDArray "
                f"{'x'.join(map(str, self.shape))} @{self.context!r}>")

    def __len__(self):
        if self._data.dim() == 0:
            raise TypeError("len() of 0-d NDArray")
        return self._data.shape[0]

    # ------------------------------------------------------------ host reads
    def asnumpy(self) -> np.ndarray:
        """Copy to host memory; waits for the value (a sync point).  The
        result is a copy on the CPU too (``Tensor.numpy`` would share the
        array's memory, and a later write to the array would show)."""
        t = self._data.detach()
        if t.is_cuda:
            _engine.host_reads += 1
            return (t.float() if t.dtype == torch.bfloat16 else t) \
                .cpu().numpy()
        return t.float().numpy() if t.dtype == torch.bfloat16 \
            else t.numpy().copy()

    def asscalar(self):
        if self.size != 1:
            raise ValueError("the array is not scalar-sized")
        if self._data.is_cuda:
            _engine.host_reads += 1
        return self._data.detach().reshape(()).item()

    item = asscalar

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __bool__(self):
        if self.size == 0:
            return False
        if self.size == 1:
            return bool(self.asscalar())
        raise ValueError("ambiguous truth value of multi-element NDArray")

    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a

    def wait_to_read(self) -> None:
        """Block until this array's value is computed."""
        _engine.wait_for(self._data)

    def tostype(self, stype: str) -> "NDArray":
        if stype != "default":
            raise MXNetError(f"storage type {stype!r} is not ported")
        return self

    # ------------------------------------------------------ movement, copies
    def copyto(self, other) -> "NDArray":
        """Copy into an existing ``NDArray`` (which keeps its dtype) or
        onto a context, as a new array."""
        if isinstance(other, NDArray):
            if other.shape != self.shape:
                raise ValueError(f"shape mismatch {self.shape} vs "
                                 f"{other.shape}")
            with torch.no_grad():
                other._data.copy_(self._data)
            return other
        if isinstance(other, (str, torch.device)):
            return NDArray(self._data.detach().to(as_device(other),
                                                  copy=True))
        raise TypeError(f"copyto target must be NDArray or a context, got "
                        f"{type(other).__name__}")

    def as_in_context(self, ctx: DeviceLike) -> "NDArray":
        if as_device(ctx) == self._data.device:
            return self
        return self.copyto(ctx)

    as_in_ctx = as_in_context

    def copy(self) -> "NDArray":
        with _grad_mode():
            return NDArray(self._data.clone())

    def astype(self, dtype, copy: bool = True) -> "NDArray":
        dt = torch_dtype(dtype)
        if not copy and dt == self._data.dtype:
            return self
        with _grad_mode():
            return NDArray(self._data.to(dt, copy=True))

    def detach(self) -> "NDArray":
        return NDArray(self._data.detach())

    # --------------------------------------------------------------- autograd
    def attach_grad(self, grad_req: str = "write", stype=None) -> None:
        """Make this array a leaf with a zero gradient buffer; later
        backward passes write (``"write"``) or add (``"add"``) into it."""
        self._data = attach(self._data, grad_req)

    def backward(self, out_grad: Optional["NDArray"] = None,
                 retain_graph: bool = False, train_mode: bool = True) -> None:
        _ag.backward([self], [out_grad], retain_graph=retain_graph,
                     train_mode=train_mode)

    # --------------------------------------------------------- views, indexing
    def reshape(self, *shape, **kwargs) -> "NDArray":
        """A view of a new shape (MXNet's codes 0, -1, -2, -3, -4, with
        ``reverse``); writes through it reach this array."""
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        shape = kwargs.get("shape", shape)
        new = resolve_reshape(self.shape, shape,
                              bool(kwargs.get("reverse", False)))
        with _grad_mode():
            return NDArray(self._data.reshape(new))

    def reshape_like(self, other) -> "NDArray":
        return self.reshape(other.shape)

    def flatten(self) -> "NDArray":
        return self.reshape((self.shape[0], -1)) if self.ndim > 1 else self

    def __getitem__(self, key) -> "NDArray":
        with _grad_mode():
            return NDArray(self._data[_index(key)])

    def __setitem__(self, key, value) -> None:
        if isinstance(value, NDArray):
            value = value._data
        elif isinstance(value, (np.ndarray, list)):
            value = torch.as_tensor(np.asarray(value),
                                    device=self._data.device)
        with _grad_mode():
            self._data[_index(key)] = value

    # -------------------------------------------------------------- arithmetic
    def _binop(self, name, other, reverse=False):
        return _reg.invoke_binary(name, self, other, reverse=reverse)

    def _inplace(self, name, other):
        res = _reg.invoke_binary(name, self, other)
        with _grad_mode():
            self._data.copy_(res._data)
        return self

    def __add__(self, o):
        return self._binop("broadcast_add", o)

    def __radd__(self, o):
        return self._binop("broadcast_add", o, reverse=True)

    def __iadd__(self, o):
        return self._inplace("broadcast_add", o)

    def __sub__(self, o):
        return self._binop("broadcast_sub", o)

    def __rsub__(self, o):
        return self._binop("broadcast_sub", o, reverse=True)

    def __isub__(self, o):
        return self._inplace("broadcast_sub", o)

    def __mul__(self, o):
        return self._binop("broadcast_mul", o)

    def __rmul__(self, o):
        return self._binop("broadcast_mul", o, reverse=True)

    def __imul__(self, o):
        return self._inplace("broadcast_mul", o)

    def __truediv__(self, o):
        return self._binop("broadcast_div", o)

    def __rtruediv__(self, o):
        return self._binop("broadcast_div", o, reverse=True)

    def __itruediv__(self, o):
        return self._inplace("broadcast_div", o)

    def __mod__(self, o):
        return self._binop("broadcast_mod", o)

    def __rmod__(self, o):
        return self._binop("broadcast_mod", o, reverse=True)

    def __pow__(self, o):
        return self._binop("broadcast_power", o)

    def __rpow__(self, o):
        return self._binop("broadcast_power", o, reverse=True)

    def __neg__(self):
        return _reg.invoke_by_name("negative", [self], {})

    def __abs__(self):
        return _reg.invoke_by_name("abs", [self], {})

    def __eq__(self, o):
        return self._binop("broadcast_equal", o)

    def __ne__(self, o):
        return self._binop("broadcast_not_equal", o)

    def __lt__(self, o):
        return self._binop("broadcast_lesser", o)

    def __le__(self, o):
        return self._binop("broadcast_lesser_equal", o)

    def __gt__(self, o):
        return self._binop("broadcast_greater", o)

    def __ge__(self, o):
        return self._binop("broadcast_greater_equal", o)

    def __and__(self, o):
        return self._binop("broadcast_logical_and", o)

    def __rand__(self, o):
        return self._binop("broadcast_logical_and", o, reverse=True)

    def __or__(self, o):
        return self._binop("broadcast_logical_or", o)

    def __ror__(self, o):
        return self._binop("broadcast_logical_or", o, reverse=True)

    def __xor__(self, o):
        return self._binop("broadcast_logical_xor", o)

    def __rxor__(self, o):
        return self._binop("broadcast_logical_xor", o, reverse=True)

    def __invert__(self):
        return _reg.invoke_by_name("logical_not", [self], {})

    __hash__ = None   # mutable

    # the reductions, transpose, dot, broadcast_to and the other fluent
    # methods are attached from the nd frontends in ``__init__.py``


# ----------------------------------------------------------------- helpers

def resolve_reshape(in_dims, spec, reverse: bool = False) -> Tuple[int, ...]:
    """Resolve MXNet's reshape codes (``matrix_op-inl.h``): 0 copies the
    input dim, -1 infers one, -2 copies the rest, -3 merges the next two,
    -4 d1 d2 splits one into (d1, d2) (either may be -1); ``reverse``
    applies them right to left.  The port's copy of the JAX package's
    ``base.resolve_reshape_spec``."""
    in_dims = list(in_dims)
    spec = [int(s) for s in spec]
    units = []
    j = 0
    while j < len(spec):
        if spec[j] == -4:
            units.append(spec[j:j + 3])
            j += 3
        else:
            units.append([spec[j]])
            j += 1
    if reverse:
        units = [([-4, u[2], u[1]] if u[0] == -4 else u)
                 for u in units[::-1]]
        in_dims = in_dims[::-1]
    out = []
    i = 0
    for u in units:
        s = u[0]
        if s == 0:
            out.append(in_dims[i])
            i += 1
        elif s == -2:
            out.extend(in_dims[i:])
            i = len(in_dims)
        elif s == -3:
            out.append(in_dims[i] * in_dims[i + 1])
            i += 2
        elif s == -4:
            d1, d2 = u[1], u[2]
            if d1 == -1:
                d1 = in_dims[i] // d2
            if d2 == -1:
                d2 = in_dims[i] // d1
            out.extend([d1, d2])
            i += 1
        else:
            out.append(s)
            i += 1
    if reverse:
        out = out[::-1]
    if -1 in out:
        known = int(np.prod([s for s in out if s != -1]))
        out[out.index(-1)] = int(np.prod(in_dims)) // max(known, 1)
    return tuple(out)


# ------------------------------------------------------------ constructors

def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _dtype(dtype) -> torch.dtype:
    return torch.float32 if dtype is None else torch_dtype(dtype)


def array(source, ctx: DeviceLike = None, dtype=None) -> NDArray:
    """A new array on ``ctx`` holding a copy of ``source`` (an NDArray, a
    tensor, a numpy array, a number or a nested list).  Without ``dtype``
    an array or a tensor keeps its dtype (float64 numpy becomes float32),
    and numbers and lists become float32."""
    dev = as_device(ctx)
    if isinstance(source, NDArray):
        source = source._data
    if isinstance(source, torch.Tensor):
        dt = source.dtype if dtype is None else torch_dtype(dtype)
        return NDArray(source.detach().to(device=dev, dtype=dt, copy=True))
    npv = np.asarray(source)
    if any(st < 0 for st in npv.strides):     # a reversed view
        npv = np.ascontiguousarray(npv)
    if dtype is not None:
        return NDArray(torch.tensor(npv, dtype=torch_dtype(dtype),
                                    device=dev))
    if isinstance(source, np.ndarray):
        if npv.dtype == np.float64:
            npv = npv.astype(np.float32)
    elif npv.dtype.kind in "ifu":
        npv = npv.astype(np.float32)
    return NDArray(torch.tensor(npv, device=dev))


def zeros(shape, ctx: DeviceLike = None, dtype=None, **kwargs) -> NDArray:
    return NDArray(torch.zeros(_shape(shape), dtype=_dtype(dtype),
                               device=as_device(ctx)))


def ones(shape, ctx: DeviceLike = None, dtype=None, **kwargs) -> NDArray:
    return NDArray(torch.ones(_shape(shape), dtype=_dtype(dtype),
                              device=as_device(ctx)))


def empty(shape, ctx: DeviceLike = None, dtype=None) -> NDArray:
    """Uninitialised, as in MXNet."""
    return NDArray(torch.empty(_shape(shape), dtype=_dtype(dtype),
                               device=as_device(ctx)))


def full(shape, val, ctx: DeviceLike = None, dtype=None) -> NDArray:
    return NDArray(torch.full(_shape(shape), val, dtype=_dtype(dtype),
                              device=as_device(ctx)))


def arange(start, stop=None, step=1.0, repeat=1, ctx: DeviceLike = None,
           dtype=None) -> NDArray:
    if stop is None:
        start, stop = 0, start
    val = torch.arange(start, stop, step, dtype=_dtype(dtype),
                       device=as_device(ctx))
    if repeat != 1:
        val = val.repeat_interleave(int(repeat))
    return NDArray(val)


def eye(N, M=0, k=0, ctx: DeviceLike = None, dtype=None) -> NDArray:
    """``N`` x ``M`` (``M=0``: square) with ones on diagonal ``k``."""
    n, m = int(N), int(M) if M else int(N)
    base = torch.ones(max(0, min(n, m - k) if k >= 0 else min(n + k, m)),
                      dtype=_dtype(dtype), device=as_device(ctx))
    out = torch.zeros((n, m), dtype=_dtype(dtype), device=as_device(ctx))
    if base.numel():
        out.diagonal(int(k)).copy_(base)
    return NDArray(out)


def linspace(start, stop, num, endpoint=True, ctx: DeviceLike = None,
             dtype=None) -> NDArray:
    num = int(num)
    if endpoint:
        val = torch.linspace(start, stop, num, dtype=torch.float64)
    else:
        val = torch.linspace(start, stop, num + 1,
                             dtype=torch.float64)[:num]
    return NDArray(val.to(device=as_device(ctx), dtype=_dtype(dtype)))


from . import register as _reg  # noqa: E402  (register imports NDArray)
