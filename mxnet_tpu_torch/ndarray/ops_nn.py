"""Neural-network operators as functions on tensors: ``log_softmax``.

Counterpart of the ``log_softmax`` registration in
``mxnet_tpu/ndarray/ops_nn.py`` (:244-250), with its signature.  The rest
of that module's registry is not ported yet.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..base import MXNetError, torch_dtype
from ..contrib.amp import amp as _amp
from .ndarray import write_out

__all__ = ["log_softmax"]


def log_softmax(data: torch.Tensor, axis: int = -1,
                temperature: Optional[float] = None, dtype=None,
                use_length: bool = False,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``log(softmax(data / temperature))`` over ``axis``
    (``temperature`` None or 0 means 1).  ``dtype``, if given, is the
    output dtype; ``use_length`` is not ported.  Under AMP the input is
    cast to float32 (an ``FP32_OPS`` op).  ``out`` receives the result in
    its own dtype and is returned."""
    if use_length:
        raise MXNetError("log_softmax: use_length=True is not ported")
    data, = _amp.cast("log_softmax", data)
    xs = data / temperature if temperature else data
    res = torch.log_softmax(xs, dim=axis)
    if dtype is not None:
        res = res.to(torch_dtype(dtype))
    return write_out(res, out)
