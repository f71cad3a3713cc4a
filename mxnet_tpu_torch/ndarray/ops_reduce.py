"""Reductions: ``sum``, ``mean``, ``prod``, ``max``, ``min``, ``argmax``
and ``argmin``.

Counterpart of ``mxnet_tpu/ndarray/ops_reduce.py`` (``_make_reduce``
:33-47; ``sum``/``mean`` :52-54, ``max`` :58, ``argmax`` :82), with its
conventions: ``axis`` is an int, a tuple or None (every axis),
``exclude=True`` reduces over every axis *except* those given, and an
fp16/bf16 input of ``sum``/``mean`` accumulates in float32 and returns
its own dtype (``MXNET_SAFE_ACCUMULATION``).  ``argmax``/``argmin``
return the indices as float32 (MXNet's convention).  Under AMP ``sum``
and ``mean`` are ``FP32_OPS``: the input is cast to float32 first.
"""
from __future__ import annotations

import torch

from ..contrib.amp import amp as _amp
from .register import register_op

_LOW = (torch.float16, torch.bfloat16)


def _axes(x: torch.Tensor, axis, exclude: bool):
    if axis is None:
        return None
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    axes = tuple(a % x.dim() for a in axes)
    if exclude:
        axes = tuple(a for a in range(x.dim()) if a not in axes)
    return axes


def _make_reduce(op_name, fn, acc32=False, amp=False):
    def maker(axis=None, keepdims=False, exclude=False):
        def reduce(data):
            if amp:
                data, = _amp.cast(op_name, data)
            axes = _axes(data, axis, exclude)
            if axes == ():
                return data.clone()          # no axis to reduce
            low = acc32 and data.dtype in _LOW
            acc = data.float() if low else data
            res = fn(acc) if axes is None else fn(acc, dim=axes,
                                                  keepdim=keepdims)
            if keepdims and axes is None:
                res = res.reshape((1,) * data.dim())
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


def _register():
    register_op("sum", _make_reduce("sum", torch.sum, acc32=True, amp=True),
                aliases=("sum_axis",))
    register_op("mean", _make_reduce("mean", torch.mean, acc32=True,
                                     amp=True))
    register_op("prod", _make_reduce("prod", _prod))
    register_op("max", _make_reduce("max", torch.amax),
                aliases=("max_axis",))
    register_op("min", _make_reduce("min", torch.amin),
                aliases=("min_axis",))
    register_op("argmax", _arg(torch.argmax))
    register_op("argmin", _arg(torch.argmin))


_register()
