"""Gluon utilities: batch splitting, global-norm clipping, file checks.

Counterpart of ``mxnet_tpu/gluon/utils.py`` (:20-95).
``clip_global_norm`` takes ``NDArray``s or tensors: the squares are
summed on their device in fp32 (``multi_sum_sq``), read back once (one
host read, counted in ``engine.stats()["host_reads"]`` on the card) and,
where the norm exceeds ``max_norm``, every array is scaled in place by
``max_norm / (norm + 1e-8)``; it returns the norm.  ``download`` raises:
the port fetches nothing.
"""
from __future__ import annotations

import hashlib
import warnings
from typing import List, Sequence

import numpy as np
import torch

from ..base import MXNetError
from ..context import DeviceLike
from ..engine import engine as _engine
from ..ndarray import ops_optimizer
from ..ndarray.ndarray import NDArray, array as nd_array

__all__ = ["split_data", "split_and_load", "clip_global_norm", "check_sha1",
           "download"]


def split_data(data: NDArray, num_slice: int, batch_axis: int = 0,
               even_split: bool = True) -> List[NDArray]:
    """``num_slice`` slices of ``data`` along ``batch_axis``; the last
    takes the remainder unless ``even_split`` requires none."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise MXNetError(
            f"data with shape {data.shape} cannot be evenly split into "
            f"{num_slice} slices along axis {batch_axis}; set "
            f"even_split=False")
    step = size // num_slice
    slices = []
    for i in range(num_slice):
        idx = [slice(None)] * data.ndim
        idx[batch_axis] = slice(i * step, (i + 1) * step
                                if i < num_slice - 1 else size)
        slices.append(data[tuple(idx)])
    return slices


def split_and_load(data, ctx_list: Sequence[DeviceLike], batch_axis: int = 0,
                   even_split: bool = True) -> List[NDArray]:
    """Split a batch along ``batch_axis`` and put each slice on one
    context of ``ctx_list``."""
    if not isinstance(data, NDArray):
        data = nd_array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(ctx) for s, ctx in zip(slices, ctx_list)]


@torch.no_grad()
def clip_global_norm(arrays, max_norm: float,
                     check_isfinite: bool = True) -> float:
    """Scale ``arrays`` in place so that their joint L2 norm is at most
    ``max_norm``; returns the norm before scaling."""
    if not arrays:
        raise MXNetError("no arrays to clip")
    tensors = [a._data if isinstance(a, NDArray) else a for a in arrays]
    total_sq = ops_optimizer.multi_sum_sq(*tensors).sum()
    if total_sq.is_cuda:
        _engine().host_reads += 1
    total = float(np.sqrt(np.float32(total_sq.item())))
    if check_isfinite and not np.isfinite(total):
        warnings.warn("nan or inf in clip_global_norm")
    scale = max_norm / (total + 1e-8)
    if scale < 1.0:
        torch._foreach_mul_(tensors, scale)
    return total


def check_sha1(filename: str, sha1_hash: str) -> bool:
    """Whether the file's SHA-1 is ``sha1_hash``."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            sha1.update(chunk)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None, retries=5,
             verify_ssl=True):
    raise MXNetError("this environment has no network egress; place files "
                     "locally and load them directly")
