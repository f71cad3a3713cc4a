"""Reductions and orderings: ``sum``, ``mean``, ``prod``, ``nansum``,
``nanprod``, ``max``, ``min``, ``norm``, ``argmax``, ``argmin``,
``argmax_channel``, ``topk``, ``sort`` and ``argsort``.

Counterpart of ``mxnet_tpu/ndarray/ops_reduce.py`` (``_make_reduce``
:33-47; ``sum``/``mean`` :52-54, ``nansum``/``nanprod`` :56-57, ``max``
:58, ``norm`` :62-74, ``argmax`` :82, ``argmax_channel`` :94, ``topk``
:98-120, ``sort`` :122-127, ``argsort`` :129-136), with its
conventions: ``axis`` is an int, a tuple or None (every axis),
``exclude=True`` reduces over every axis *except* those given, and an
fp16/bf16 input of ``sum``/``mean``/``nansum`` (and ``norm``)
accumulates in float32 and returns its own dtype
(``MXNET_SAFE_ACCUMULATION``; ``norm``'s ``out_dtype`` if given).
``argmax``/``argmin``/``argmax_channel`` return the indices as float32
(MXNet's convention), ``topk``/``argsort`` in ``dtype``.  Under AMP
``sum`` and ``mean`` are ``FP32_OPS``: the input is cast to float32
first.
An int8/int16/int32 input of ``sum``/``prod``/``nansum``/``nanprod``
answers int32, wrapping as int32 arithmetic does, and of ``mean`` float32
(the JAX package's dtypes, and MXNet's); int64 stays int64.

Ties are ordered as the JAX package orders them, by stable sorts only
(``torch.topk``'s order of equal values on the card is unspecified):
``topk`` is a stable sort of ``x`` ascending, or of ``-x`` descending, so
equal values come lowest index first either way; ``sort``/``argsort``
descending is the stable ascending sort flipped, so there equal values
come highest index first.
"""
from __future__ import annotations

import torch

from ..base import MXNetError, torch_dtype
from ..contrib.amp import amp as _amp
from .register import register_op

_LOW = (torch.float16, torch.bfloat16)
#: integer inputs whose sums and products are int32, as the JAX package's
SMALL_INT = (torch.int8, torch.int16, torch.int32)


def int32_result(x: torch.Tensor, res: torch.Tensor) -> torch.Tensor:
    """``res``, a sum or product over ``x`` that torch made int64, as the
    int32 of the JAX package: integer sums and products are exact modulo
    2**64, so the cast keeps int32's wrapped value."""
    return res.to(torch.int32) if x.dtype in SMALL_INT else res


def _axes(x: torch.Tensor, axis, exclude: bool):
    if axis is None:
        return None
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    axes = tuple(a % x.dim() for a in axes)
    if exclude:
        axes = tuple(a for a in range(x.dim()) if a not in axes)
    return axes


def _make_reduce(op_name, fn, acc32=False, amp=False, ints=None):
    """``ints``: what an int8/16/32 input gives, ``"int32"`` (sums and
    products) or ``"float32"`` (``mean``); other reductions keep it."""
    def maker(axis=None, keepdims=False, exclude=False):
        def reduce(data):
            if amp:
                data, = _amp.cast(op_name, data)
            if ints == "float32" and data.dtype in SMALL_INT:
                data = data.float()
            axes = _axes(data, axis, exclude)
            if axes == ():
                return data.clone()          # no axis to reduce
            low = acc32 and data.dtype in _LOW
            acc = data.float() if low else data
            res = fn(acc) if axes is None else fn(acc, dim=axes,
                                                  keepdim=keepdims)
            if keepdims and axes is None:
                res = res.reshape((1,) * data.dim())
            if ints == "int32":
                res = int32_result(data, res)
            return res.to(data.dtype) if low else res
        return reduce
    return maker


def _prod(x, dim=None, keepdim=False):
    if dim is None:
        return torch.prod(x)
    for d in sorted(dim, reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


def _arg(fn):
    def maker(axis=None, keepdims=False):
        def f(x):
            if axis is None:
                return fn(x).float()
            return fn(x, dim=axis, keepdim=keepdims).float()
        return f
    return maker


def _nanprod(x, dim=None, keepdim=False):
    return _prod(torch.nan_to_num(x, nan=1.0), dim, keepdim)


def norm_maker(ord=2, axis=None, out_dtype=None, keepdims=False):
    """The L1 (``ord=1``) or L2 norm over ``axis`` (every axis if None),
    accumulated in float32 for fp16/bf16 input."""
    if ord not in (1, 2):
        raise MXNetError(f"norm: ord {ord!r} not in (1, 2)")
    out_dt = None if out_dtype is None else torch_dtype(out_dtype)

    def fn(x):
        axes = _axes(x, axis, False)
        acc = x.float() if x.dtype in _LOW else x
        dims = axes if axes is not None else tuple(range(x.dim()))
        if ord == 1:
            r = acc.abs().sum(dim=dims, keepdim=keepdims)
        else:
            r = acc.square().sum(dim=dims, keepdim=keepdims).sqrt()
        return r.to(out_dt or x.dtype)
    return fn


def argmax_channel_maker():
    def fn(x):
        return torch.argmax(x, dim=1).float()
    return fn


def _stable_argsort(x: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.sort(x, dim=dim, stable=True).indices


def topk_maker(axis=-1, k=1, ret_typ="indices", is_ascend=False,
               dtype="float32"):
    if ret_typ not in ("indices", "value", "both", "mask"):
        raise MXNetError(f"topk: ret_typ {ret_typ!r} not in indices, "
                         f"value, both, mask")
    dt = torch_dtype(dtype)

    def fn(x):
        ax = axis % x.dim()
        key = x if is_ascend else -x
        idx = _stable_argsort(key, ax).narrow(ax, 0, k)
        if ret_typ == "mask":
            return torch.zeros_like(x).scatter_(ax, idx, 1)
        vals = torch.take_along_dim(x, idx, dim=ax)
        if ret_typ == "value":
            return vals
        if ret_typ == "indices":
            return idx.to(dt)
        return vals, idx.to(dt)
    return fn


def sort_maker(axis=-1, is_ascend=True):
    def fn(x):
        r = torch.sort(x, dim=axis, stable=True).values
        return r if is_ascend else torch.flip(r, (axis,))
    return fn


def argsort_maker(axis=-1, is_ascend=True, dtype="float32"):
    dt = torch_dtype(dtype)

    def fn(x):
        r = _stable_argsort(x, axis)
        return (r if is_ascend else torch.flip(r, (axis,))).to(dt)
    return fn


def _register():
    register_op("sum", _make_reduce("sum", torch.sum, acc32=True, amp=True,
                                    ints="int32"),
                aliases=("sum_axis",))
    register_op("mean", _make_reduce("mean", torch.mean, acc32=True,
                                     amp=True, ints="float32"))
    register_op("prod", _make_reduce("prod", _prod, ints="int32"))
    register_op("nansum", _make_reduce("nansum", torch.nansum,
                                       acc32=True, ints="int32"))
    register_op("nanprod", _make_reduce("nanprod", _nanprod,
                                        ints="int32"))
    register_op("norm", norm_maker)
    register_op("max", _make_reduce("max", torch.amax),
                aliases=("max_axis",))
    register_op("min", _make_reduce("min", torch.amin),
                aliases=("min_axis",))
    register_op("argmax", _arg(torch.argmax))
    register_op("argmin", _arg(torch.argmin))
    register_op("argmax_channel", argmax_channel_maker)
    register_op("topk", topk_maker)
    register_op("sort", sort_maker)
    register_op("argsort", argsort_maker)


_register()
