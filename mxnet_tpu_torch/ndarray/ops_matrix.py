"""Matrix operators as functions on tensors: ``pick``.

Counterpart of the ``pick`` registration in
``mxnet_tpu/ndarray/ops_matrix.py`` (:235-243), with its signature.  The
rest of that module's registry is not ported yet.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..base import MXNetError
from .ndarray import write_out

__all__ = ["pick"]


def pick(data: torch.Tensor, index: torch.Tensor, axis: int = -1,
         keepdims: bool = False, mode: str = "clip",
         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``data``'s element at ``index`` along ``axis``: ``index`` has
    ``data``'s shape without that axis (float indices are truncated).
    ``mode="clip"`` clips indices into range, ``"wrap"`` wraps them.  The
    axis is kept with size 1 when ``keepdims``."""
    if mode not in ("clip", "wrap"):
        raise MXNetError(f"pick: mode {mode!r} not in ('clip', 'wrap')")
    ax = axis % data.dim()
    n = data.shape[ax]
    idx = index.long()
    idx = idx.clamp(0, n - 1) if mode == "clip" else idx.remainder(n)
    res = torch.take_along_dim(data, idx.unsqueeze(ax), dim=ax)
    return write_out(res if keepdims else res.squeeze(ax), out)
