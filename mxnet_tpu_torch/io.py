"""Data iterators: ``DataDesc``, ``DataBatch``, ``DataIter`` and
``NDArrayIter``.

Counterpart of ``mxnet_tpu/io.py`` (:40-226), the part that the Module
API drives: a ``DataIter`` yields ``DataBatch``es of ``NDArray``s on the
CPU (the executor copies them onto its device), ``provide_data`` and
``provide_label`` describe them as ``DataDesc``s.  ``NDArrayIter`` walks
in-memory arrays with ``shuffle`` and ``last_batch_handle`` ``pad``
(wrap to the front), ``discard`` or ``roll_over``, its shuffle order drawn
from numpy's global stream.  The record, CSV, MNIST and image iterators
are not ported.
"""
from __future__ import annotations

import collections
from typing import List, Optional

import numpy as _np

from .base import MXNetError
from .context import cpu
from .ndarray import NDArray, array as nd_array

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter"]


class DataDesc(collections.namedtuple("DataDesc", ["name", "shape", "dtype",
                                                   "layout"])):
    """Name, shape, dtype and layout of one input stream."""

    def __new__(cls, name, shape, dtype=_np.float32, layout="NCHW"):
        return super().__new__(cls, name, tuple(shape), _np.dtype(dtype),
                               layout)

    @staticmethod
    def get_batch_axis(layout: Optional[str]) -> int:
        return 0 if not layout else layout.find("N")


class DataBatch:
    """One minibatch: data/label lists + padding bookkeeping."""

    def __init__(self, data, label=None, pad=0, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        self.data = data if isinstance(data, (list, tuple)) or data is None \
            else [data]
        self.label = label if isinstance(label, (list, tuple)) \
            or label is None else [label]
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label

    def __repr__(self):
        shapes = [getattr(d, "shape", None) for d in (self.data or [])]
        return f"DataBatch: data shapes: {shapes} pad: {self.pad}"


class DataIter:
    """Base iterator (reference: io.DataIter).  Subclasses implement
    ``next()`` raising StopIteration, plus ``reset()``."""

    def __init__(self, batch_size: int = 0):
        self.batch_size = batch_size

    def __iter__(self):
        self.reset()
        return self

    def __next__(self):
        return self.next()

    def reset(self) -> None:
        pass

    def next(self) -> DataBatch:
        if self.iter_next():
            return DataBatch(self.getdata(), self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    # low-level protocol (only used if next() is not overridden)
    def iter_next(self) -> bool:
        return False

    def getdata(self):
        return None

    def getlabel(self):
        return None

    def getindex(self):
        return None

    def getpad(self):
        return 0


def _init_data(data, allow_empty: bool, default_name: str):
    """Normalize data into an ordered list of (name, numpy array)."""
    if data is None:
        if not allow_empty:
            raise MXNetError("data cannot be None")
        return []
    if isinstance(data, (_np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, (list, tuple)):
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {f"_{i}_{default_name}": d for i, d in enumerate(data)}
    out = []
    for k, v in data.items():
        if isinstance(v, NDArray):
            v = v.asnumpy()
        out.append((k, _np.asarray(v)))
    return out


class NDArrayIter(DataIter):
    """Iterate over in-memory arrays (reference: io.NDArrayIter), with
    shuffle and ``last_batch_handle`` in {'pad', 'discard', 'roll_over'}."""

    def __init__(self, data, label=None, batch_size: int = 1,
                 shuffle: bool = False, last_batch_handle: str = "pad",
                 data_name: str = "data", label_name: str = "softmax_label"):
        super().__init__(batch_size)
        self.data = _init_data(data, False, data_name)
        self.label = _init_data(label, True, label_name)
        self.num_data = self.data[0][1].shape[0]
        for _, arr in self.data + self.label:
            if arr.shape[0] != self.num_data:
                raise MXNetError("all data/label arrays must share axis 0")
        if last_batch_handle not in ("pad", "discard", "roll_over"):
            raise MXNetError(f"bad last_batch_handle {last_batch_handle!r}")
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.idx = _np.arange(self.num_data)
        # seeded from the GLOBAL numpy stream so mx.random.seed()/the test
        # harness's per-test seeding controls shuffle order (reference
        # parity: the C++ iterators draw from the seeded global RNG)
        self._rng = _np.random.default_rng(
            _np.random.randint(0, 2 ** 31))
        self.cursor = -batch_size
        self._carry = _np.empty(0, dtype=_np.int64)
        self._epoch_idx = self.idx
        self.reset()

    @property
    def provide_data(self) -> List[DataDesc]:
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self) -> List[DataDesc]:
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.label]

    def reset(self) -> None:
        if self.shuffle:
            self._rng.shuffle(self.idx)
        # roll_over: the partial tail of the previous epoch is served first
        # (reference NDArrayIter roll_over semantics — no sample skipped,
        # no sample duplicated)
        if self._carry.size:
            self._epoch_idx = _np.concatenate([self._carry, self.idx])
            self._carry = _np.empty(0, dtype=_np.int64)
        else:
            self._epoch_idx = self.idx
        self.cursor = -self.batch_size

    def iter_next(self) -> bool:
        self.cursor += self.batch_size
        n = len(self._epoch_idx)
        if self.last_batch_handle in ("discard", "roll_over"):
            return self.cursor + self.batch_size <= n
        return self.cursor < n

    def next(self) -> DataBatch:
        if not self.iter_next():
            if self.last_batch_handle == "roll_over":
                self._carry = self._epoch_idx[self.cursor:].astype(
                    _np.int64)
            raise StopIteration
        data = [self._slice(arr) for _, arr in self.data]
        label = [self._slice(arr) for _, arr in self.label]
        pad = self.getpad()
        return DataBatch([nd_array(d, ctx=cpu()) for d in data],
                         [nd_array(l, ctx=cpu()) for l in label],
                         pad=pad, index=None,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)

    def _slice(self, arr: _np.ndarray) -> _np.ndarray:
        n = len(self._epoch_idx)
        start = max(self.cursor, 0)
        end = self.cursor + self.batch_size
        sel = self._epoch_idx[start:min(end, n)]
        out = arr[sel]
        if out.shape[0] < self.batch_size:
            # pad by wrapping to the front (reference 'pad' semantics)
            extra = arr[self._epoch_idx[:self.batch_size - out.shape[0]]]
            out = _np.concatenate([out, extra], axis=0)
        return out

    def getpad(self) -> int:
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > len(self._epoch_idx):
            return self.cursor + self.batch_size - len(self._epoch_idx)
        return 0
