"""Reductions as functions on tensors: ``sum`` and ``mean``.

Counterpart of ``mxnet_tpu/ndarray/ops_reduce.py`` (``_make_reduce``,
:33-47; ``sum``/``mean`` at :52-54), with its signature and conventions:
``axis`` is an int, a tuple or None (every axis), ``exclude=True`` reduces
over every axis *except* those given, and an fp16/bf16 input accumulates
in float32 and returns its own dtype (``MXNET_SAFE_ACCUMULATION``).  Under
AMP both are ``FP32_OPS``: the input is cast to float32 first.  The other
reductions are not ported yet.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..contrib.amp import amp as _amp
from .ndarray import write_out

__all__ = ["sum", "mean"]


def _axes(x: torch.Tensor, axis, exclude: bool):
    if axis is None:
        return None
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    axes = tuple(a % x.dim() for a in axes)
    if exclude:
        axes = tuple(a for a in range(x.dim()) if a not in axes)
    return axes


def _reduce(op_name, fn, data, axis, keepdims, exclude, out):
    data, = _amp.cast(op_name, data)
    axes = _axes(data, axis, exclude)
    if axes == ():
        res = data                   # no axis to reduce
    else:
        low = data.dtype in (torch.float16, torch.bfloat16)
        acc = data.float() if low else data
        res = fn(acc) if axes is None else fn(acc, dim=axes,
                                                keepdim=keepdims)
        if keepdims and axes is None:
            res = res.reshape((1,) * data.dim())
        res = res.to(data.dtype) if low else res
    return write_out(res, out)


def sum(data: torch.Tensor, axis=None, keepdims: bool = False,
        exclude: bool = False,
        out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sum over ``axis`` (see the module docstring)."""
    return _reduce("sum", torch.sum, data, axis, keepdims, exclude, out)


def mean(data: torch.Tensor, axis=None, keepdims: bool = False,
         exclude: bool = False,
         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean over ``axis`` (see the module docstring)."""
    return _reduce("mean", torch.mean, data, axis, keepdims, exclude, out)

