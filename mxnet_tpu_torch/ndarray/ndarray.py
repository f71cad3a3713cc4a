"""Array creation on a device: ``array``, ``zeros``, ``ones``, ``empty``
and ``full``.

Counterpart of the constructors of ``mxnet_tpu/ndarray/ndarray.py``
(:579-640).  The port has no ``NDArray`` type: each function returns a
``torch.Tensor`` on ``ctx`` (``gpu(0)`` unless the caller passes
``cpu()``).  The default dtype is MXNet's float32: ``array`` keeps the
dtype of a tensor and of a numpy array (float64 becomes float32), and
makes float32 of Python numbers and lists; ``empty`` is uninitialised, as
in MXNet.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import torch_dtype
from ..context import DeviceLike, as_device

__all__ = ["array", "zeros", "ones", "empty", "full"]


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _dtype(dtype) -> torch.dtype:
    return torch.float32 if dtype is None else torch_dtype(dtype)


def array(source, ctx: DeviceLike = None, dtype=None) -> torch.Tensor:
    """A new tensor on ``ctx`` holding a copy of ``source`` (a tensor, a
    numpy array, a number or a nested list)."""
    dev = as_device(ctx)
    if isinstance(source, torch.Tensor):
        dt = source.dtype if dtype is None else torch_dtype(dtype)
        return source.detach().to(device=dev, dtype=dt, copy=True)
    npv = np.asarray(source)
    if dtype is not None:
        return torch.tensor(npv, dtype=torch_dtype(dtype), device=dev)
    if isinstance(source, np.ndarray):
        if npv.dtype == np.float64:
            npv = npv.astype(np.float32)
    elif npv.dtype.kind in "ifu":
        npv = npv.astype(np.float32)
    return torch.tensor(npv, device=dev)


def zeros(shape, ctx: DeviceLike = None, dtype=None) -> torch.Tensor:
    return torch.zeros(_shape(shape), dtype=_dtype(dtype),
                       device=as_device(ctx))


def ones(shape, ctx: DeviceLike = None, dtype=None) -> torch.Tensor:
    return torch.ones(_shape(shape), dtype=_dtype(dtype),
                      device=as_device(ctx))


def empty(shape, ctx: DeviceLike = None, dtype=None) -> torch.Tensor:
    return torch.empty(_shape(shape), dtype=_dtype(dtype),
                       device=as_device(ctx))


def full(shape, val, ctx: DeviceLike = None, dtype=None) -> torch.Tensor:
    return torch.full(_shape(shape), val, dtype=_dtype(dtype),
                      device=as_device(ctx))


def write_out(res: torch.Tensor, out) -> torch.Tensor:
    """MXNet's ``out=`` argument of an op: the result copied into ``out``
    (which keeps its dtype) and ``out`` returned, or the result as is."""
    if out is None:
        return res
    with torch.no_grad():
        out.copy_(res)
    return out
