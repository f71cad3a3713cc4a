"""Op registry and imperative dispatch: the functions behind ``mx.nd.<op>``.

Counterpart of ``mxnet_tpu/ndarray/register.py``: ``Operator`` with its
maker cache (:111-206), ``register_op`` :208, ``get_op`` :252,
``list_ops`` :259, ``invoke`` :899-990, ``split_positional_params``
:1064 and ``make_frontend`` :1089.  An op is a *maker*: ``maker(**params)
-> fn(*tensors)``; the registry keeps the ``fn`` of each parameter set
(``Operator.get_fn``), so a frontend call is one dict lookup away from
the torch code.  There is no jit and no tape: torch runs each op eagerly
on the tensors' device and records it for autograd itself.

``invoke`` takes ``NDArray``s and ``torch.Tensor``s alike:

- an ``NDArray`` input is unwrapped to its tensor, and then the results
  are ``NDArray``s.  The op runs under ``torch.no_grad()`` unless
  ``autograd.is_recording()`` (MXNet records only inside
  ``autograd.record()``; an in-place write on an array with a gradient
  outside it must not reach torch's graph);
- tensors in give tensors out, with torch's grad mode as the caller set
  it: the port's own layers and losses call the ``nd`` ops on tensors
  and pay no wrapping;
- numpy arrays and lists become tensors on the device of the other
  inputs (the current context if none), and an op without tensor inputs
  (a draw) returns ``NDArray``s, as MXNet's frontends do;
- ``out=`` (an array or a list of them) receives the results, each
  keeping its own dtype, and is returned.

Under ``NaiveEngine`` (``engine.py``) every op waits for its device.  The
JAX package's bulked segments (``_BulkSegment`` :596-740, deferred ops
fused into one XLA program) are not ported: each op launches as it is
called.
"""
from __future__ import annotations

import functools
import inspect
import threading
from time import perf_counter
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from .. import autograd as _ag
from ..base import MXNetError
from ..context import as_device
from ..engine import engine as _engine_fn
from .ndarray import NDArray

__all__ = ["Operator", "register_op", "simple_op", "get_op", "list_ops",
           "invoke", "invoke_by_name", "invoke_binary", "make_frontend",
           "split_positional_params", "boundary", "call_on_tensors", "wrap",
           "unwrap", "has_ndarray", "write_out", "add_alias", "host_read",
           "host_reads"]

_registry: Dict[str, "Operator"] = {}
_engine = _engine_fn()

#: per-Operator bound on the cache of made fns (parameter sets per op are
#: few in practice)
OP_FN_CACHE_SIZE = 128


def _canon(v: Any) -> Any:
    """A hashable, canonical form of a parameter value."""
    if isinstance(v, (list, tuple)):
        return tuple(_canon(x) for x in v)
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, np.dtype):
        return str(v)
    return v


class Operator:
    """A registered operator (the counterpart of ``nnvm::Op``)."""

    __slots__ = ("name", "maker", "aliases", "doc", "_cache")

    def __init__(self, name: str, maker: Callable,
                 aliases: Sequence[str] = (), doc: str = ""):
        self.name = name
        self.maker = maker
        self.aliases = tuple(aliases)
        self.doc = doc
        self._cache: Dict[Tuple, Callable] = {}

    def get_fn(self, kwargs: Dict[str, Any]) -> Callable:
        """The op's fn for the parameters ``kwargs``, made once per
        parameter set (uncached if a value is unhashable)."""
        try:
            key = tuple(sorted((k, _canon(v)) for k, v in kwargs.items()))
            fn = self._cache.get(key)
        except TypeError:
            return self.maker(**kwargs)
        if fn is None:
            fn = self.maker(**kwargs)
            if len(self._cache) >= OP_FN_CACHE_SIZE:
                self._cache.clear()
            self._cache[key] = fn
        return fn


def _no_grad_maker(maker: Callable) -> Callable:
    """``maker`` whose fns run under ``torch.no_grad()``."""
    @functools.wraps(maker)
    def make(**kwargs):
        fn = maker(**kwargs)

        def run(*args):
            with torch.no_grad():
                return fn(*args)
        return run
    return make


def register_op(name: str, maker: Callable = None, *,
                aliases: Sequence[str] = (), doc: str = "",
                differentiable: bool = True):
    """Register an operator; usable directly or as a decorator on the
    maker.  A name registered twice raises.  The outputs of an op
    registered ``differentiable=False`` take no gradient (its fns run
    under ``torch.no_grad()``), as the JAX package records no tape node
    for it."""
    def do(mk):
        if not differentiable:
            mk = _no_grad_maker(mk)
        op = Operator(name, mk, aliases, doc or (mk.__doc__ or ""))
        for n in (name,) + tuple(aliases):
            if n in _registry:
                raise MXNetError(f"operator name {n!r} is already "
                                 f"registered (by {_registry[n].name!r})")
            _registry[n] = op
        return mk
    if maker is not None:
        do(maker)
        return maker
    return do


def simple_op(name: str, fn: Callable, **kw) -> None:
    """Register an op without parameters."""
    register_op(name, lambda: fn, **kw)


def add_alias(existing: str, *aliases: str) -> None:
    """More names for a registered op (``mxnet_tpu/ndarray/register.py``
    :239)."""
    op = get_op(existing)
    for n in aliases:
        if n in _registry:
            raise MXNetError(f"operator name {n!r} is already registered "
                             f"(by {_registry[n].name!r})")
        _registry[n] = op
    op.aliases = op.aliases + tuple(aliases)


_host = threading.local()


def host_read(name: str, *tensors: torch.Tensor) -> None:
    """Called by an op whose output shape depends on its input's values
    (``_contrib_boolean_mask``, ``bincount``, ``histogram`` without a
    range) before it reads them back to the host.  On ``meta`` tensors
    (shape inference, which has no values) it raises ``MXNetError``
    naming the op; otherwise the read is counted on this thread
    (``host_reads``), which tells a hybridized block that its forward
    cannot be captured into a CUDA graph (``gluon/cached_op.py``)."""
    if any(t.device.type == "meta" for t in tensors):
        raise MXNetError(f"{name}: the output's shape depends on the "
                         f"input's values; it cannot be inferred from "
                         f"shapes alone")
    _host.reads = getattr(_host, "reads", 0) + 1
    _host.last = name


def host_reads():
    """(count, last op name) of ``host_read`` calls on this thread."""
    return getattr(_host, "reads", 0), getattr(_host, "last", None)


def get_op(name: str) -> Operator:
    op = _registry.get(name)
    if op is None:
        raise MXNetError(f"operator {name!r} is not registered")
    return op


def list_ops() -> List[str]:
    return sorted({op.name for op in _registry.values()})


def _tensor(x, dev: torch.device) -> torch.Tensor:
    """A numpy array or a list as a tensor on ``dev`` (float64 becomes
    MXNet's float32)."""
    a = np.asarray(x)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.as_tensor(a, device=dev)


def wrap(res):
    """Tensors (alone, or in a tuple or list) as ``NDArray``s."""
    if isinstance(res, torch.Tensor):
        return NDArray(res)
    if isinstance(res, (tuple, list)):
        return type(res)(wrap(r) for r in res)
    return res


def write_out(res, out):
    """MXNet's ``out=``: each result copied into its target (which keeps
    its dtype; a tensor or an ``NDArray``) and ``out`` returned."""
    targets = out if isinstance(out, (list, tuple)) else [out]
    results = res if isinstance(res, (list, tuple)) else [res]
    with torch.no_grad():
        for tgt, src in zip(targets, results):
            tt = tgt._data if isinstance(tgt, NDArray) else tgt
            tt.copy_(src._data if isinstance(src, NDArray) else src)
    return out


def invoke(op: Operator, inputs: Sequence, kwargs: Dict[str, Any],
           out=None):
    """Run ``op`` on ``inputs`` (see the module docstring); one result, or
    a list for a multi-output op."""
    wrapped = False
    dev = None
    args = []
    host = False
    for x in inputs:
        if isinstance(x, NDArray):
            wrapped = True
            x = x._data
        if isinstance(x, torch.Tensor):
            if dev is None:
                dev = x.device
        elif isinstance(x, (np.ndarray, list)):
            host = True
        args.append(x)
    if dev is None:
        wrapped = True
    if host:
        dev = dev or as_device(None)
        args = [_tensor(a, dev) if isinstance(a, (np.ndarray, list))
                else a for a in args]
    fn = op.get_fn(kwargs)
    hooked = _engine.hooked
    t0 = perf_counter() if hooked else 0.0
    if wrapped and not _ag.is_recording():
        with torch.no_grad():
            res = fn(*args)
    else:
        res = fn(*args)
    multi = isinstance(res, (tuple, list))
    if hooked:
        _engine.on_op(op.name, res if multi else (res,),
                      (perf_counter() - t0) * 1e6)
    if out is not None:
        return write_out(res, out)
    if wrapped:
        return [NDArray(r) for r in res] if multi else NDArray(res)
    return list(res) if multi else res


def invoke_by_name(name: str, inputs: Sequence, kwargs: Dict[str, Any],
                   out=None):
    return invoke(get_op(name), inputs, kwargs, out=out)


# the scalar forms of the binary dunders: (forward op, reflected op)
_SCALAR_MAP = {
    "broadcast_add": ("_plus_scalar", "_plus_scalar"),
    "broadcast_sub": ("_minus_scalar", "_rminus_scalar"),
    "broadcast_mul": ("_mul_scalar", "_mul_scalar"),
    "broadcast_div": ("_div_scalar", "_rdiv_scalar"),
    "broadcast_mod": ("_mod_scalar", "_rmod_scalar"),
    "broadcast_power": ("_power_scalar", "_rpower_scalar"),
    "broadcast_equal": ("_equal_scalar", "_equal_scalar"),
    "broadcast_not_equal": ("_not_equal_scalar", "_not_equal_scalar"),
    "broadcast_greater": ("_greater_scalar", "_lesser_scalar"),
    "broadcast_greater_equal": ("_greater_equal_scalar",
                                "_lesser_equal_scalar"),
    "broadcast_lesser": ("_lesser_scalar", "_greater_scalar"),
    "broadcast_lesser_equal": ("_lesser_equal_scalar",
                               "_greater_equal_scalar"),
    "broadcast_logical_and": ("_logical_and_scalar", "_logical_and_scalar"),
    "broadcast_logical_or": ("_logical_or_scalar", "_logical_or_scalar"),
    "broadcast_logical_xor": ("_logical_xor_scalar", "_logical_xor_scalar"),
}


def invoke_binary(name: str, lhs, rhs, reverse: bool = False):
    """A binary dunder: the broadcast op between two arrays, or the
    ``_*_scalar`` op with the number as its second input (cast to the
    array's dtype by the op, MXNet's rule)."""
    if isinstance(rhs, (NDArray, torch.Tensor, np.ndarray, list)):
        args = [rhs, lhs] if reverse else [lhs, rhs]
        return invoke(get_op(name), args, {})
    fwd, rev = _SCALAR_MAP[name]
    return invoke(get_op(rev if reverse else fwd), [lhs, rhs], {})


@functools.lru_cache(maxsize=None)
def _maker_param_names(op: Operator) -> Tuple[str, ...]:
    try:
        return tuple(
            p.name for p in inspect.signature(op.maker).parameters.values()
            if p.kind in (inspect.Parameter.POSITIONAL_OR_KEYWORD,
                          inspect.Parameter.KEYWORD_ONLY))
    except (TypeError, ValueError):
        return ()


#: what a frontend takes as an op's input (``symbol`` adds ``Symbol``)
_INPUT_TYPES = (NDArray, torch.Tensor, np.ndarray, list)


def register_input_type(cls) -> None:
    """Have the frontends take instances of ``cls`` as inputs."""
    global _INPUT_TYPES
    _INPUT_TYPES = _INPUT_TYPES + (cls,)


def _is_param_value(v) -> bool:
    """A positional value that is a parameter of the op, not an input:
    numbers, strings, tuples (shapes, axes), dtypes and None."""
    return not isinstance(v, _INPUT_TYPES)


def split_positional_params(op: Operator, args: Sequence,
                            kwargs: Dict[str, Any]):
    """MXNet's calling convention for the generated frontends: trailing
    positional values that are not arrays are the op's parameters in the
    maker's order (``nd.sum(x, 1)`` is ``nd.sum(x, axis=1)``)."""
    split = len(args)
    while split > 0 and _is_param_value(args[split - 1]):
        split -= 1
    if split == len(args):
        return args, kwargs
    names = _maker_param_names(op)
    extra = args[split:]
    if len(extra) > len(names):
        raise MXNetError(f"{op.name}: {len(extra)} positional parameters "
                         f"for {len(names)} ({', '.join(names)})")
    for n, v in zip(names, extra):
        if n in kwargs:
            raise TypeError(f"{op.name}() got multiple values for "
                            f"argument {n!r}")
        kwargs[n] = v
    return args[:split], kwargs


def make_frontend(op: Operator) -> Callable:
    """The user-facing ``mx.nd.<op>`` function."""
    def frontend(*args, out=None, name=None, **kwargs):
        inputs, kwargs = split_positional_params(op, args, kwargs)
        return invoke(op, inputs, kwargs, out=out)
    frontend.__name__ = op.name
    frontend.__qualname__ = op.name
    frontend.__doc__ = op.doc
    return frontend


def unwrap(x):
    """``NDArray``s (alone, or in lists and tuples) as their tensors."""
    if isinstance(x, NDArray):
        return x._data
    if isinstance(x, (tuple, list)):
        return type(x)(unwrap(v) for v in x)
    return x


def has_ndarray(args: Sequence, kwargs: Dict[str, Any]) -> bool:
    """Whether an ``NDArray`` is among ``args`` or ``kwargs``, or in a
    list or tuple among them (an RNN cell's states)."""
    def found(v):
        return isinstance(v, NDArray) or (
            isinstance(v, (list, tuple)) and any(found(e) for e in v))
    return any(found(a) for a in args) or any(
        found(v) for v in kwargs.values())


def call_on_tensors(fn: Callable, args: Sequence, kwargs: Dict[str, Any]):
    """``fn`` on the tensors of the ``NDArray``s among ``args`` and
    ``kwargs`` (also inside lists and tuples; under ``no_grad`` unless
    recording), its results as ``NDArray``s."""
    targs = [unwrap(a) for a in args]
    tkw = {k: unwrap(v) for k, v in kwargs.items()}
    if _ag.is_recording():
        return wrap(fn(*targs, **tkw))
    with torch.no_grad():
        return wrap(fn(*targs, **tkw))


def boundary(fn: Callable) -> Callable:
    """Give a function on tensors (the flash-attention kernel wrapper, the
    ``Custom`` op) the registry's ``NDArray`` rule: if any input is an
    ``NDArray``, it runs on the tensors (``call_on_tensors``); otherwise
    it is called as it is."""
    @functools.wraps(fn, updated=())
    def frontend(*args, **kwargs):
        if any(isinstance(a, NDArray) for a in args) or any(
                isinstance(a, NDArray) for a in kwargs.values()):
            return call_on_tensors(fn, args, kwargs)
        return fn(*args, **kwargs)
    return frontend
