"""NDArray files: ``mx.nd.save`` / ``mx.nd.load``.

Counterpart of ``mxnet_tpu/ndarray/utils.py`` (``save`` :26, ``load``
:47), in the same format, so a file written by either package loads in
the other: the magic ``MXTPU001``, one byte (1 for a name -> array dict,
0 for a list), then an npz archive (a list's arrays named ``__arr_<i>``).
The values round-trip bit for bit.  numpy has no bfloat16: the port
writes a bfloat16 array as float32.
"""
from __future__ import annotations

import io
import struct
from typing import Dict, List, Union

import numpy as np
import torch

from ..base import MXNetError
from ..context import DeviceLike
from .ndarray import NDArray, array

__all__ = ["save", "load", "load_buffer"]

_MAGIC = b"MXTPU001"
_LIST_PREFIX = "__arr_"

Arrays = Union[NDArray, torch.Tensor, List, Dict[str, NDArray]]


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = NDArray(v)
    return v.asnumpy()


def save(fname: str, data: Arrays) -> None:
    """Save an array, a list of arrays or a name -> array dict."""
    if isinstance(data, (NDArray, torch.Tensor)):
        data = [data]
    is_dict = isinstance(data, dict)
    payload = ({k: _host(v) for k, v in data.items()} if is_dict else
               {f"{_LIST_PREFIX}{i}": _host(v) for i, v in enumerate(data)})
    buf = io.BytesIO()
    np.savez(buf, **payload)
    with open(fname, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<B", 1 if is_dict else 0))
        f.write(buf.getvalue())


def load(fname: str, ctx: DeviceLike = None):
    """Load the arrays of :func:`save` onto ``ctx`` (the current context
    if None): a list, or a name -> array dict."""
    with open(fname, "rb") as f:
        return load_buffer(f.read(), what=fname, ctx=ctx)


def load_buffer(buf: bytes, what: str = "<buffer>", ctx: DeviceLike = None):
    if buf[:len(_MAGIC)] != _MAGIC:
        raise MXNetError(f"{what}: not an NDArray file (bad magic)")
    off = len(_MAGIC)
    is_dict = struct.unpack("<B", buf[off:off + 1])[0] == 1
    npz = np.load(io.BytesIO(buf[off + 1:]))
    if is_dict:
        return {k: array(npz[k], ctx=ctx) for k in npz.files}
    items = sorted(npz.files, key=lambda k: int(k[len(_LIST_PREFIX):]))
    return [array(npz[k], ctx=ctx) for k in items]
