"""Datasets (counterpart of ``mxnet_tpu/gluon/data/dataset.py``, MXNet's
python/mxnet/gluon/data/dataset.py): ``Dataset`` with ``transform``,
``transform_first``, ``filter`` and ``take``, ``SimpleDataset``,
``ArrayDataset`` and ``RecordFileDataset`` (raw records by position, read
with ``MXIndexedRecordIO.read_idx``, safe across loader threads)."""
from __future__ import annotations

from ...base import MXNetError

__all__ = ["Dataset", "ArrayDataset", "SimpleDataset", "RecordFileDataset"]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def transform(self, fn, lazy=True):
        trans = _LazyTransformDataset(self, fn)
        if lazy:
            return trans
        return SimpleDataset([trans[i] for i in range(len(trans))])

    def transform_first(self, fn, lazy=True):
        return self.transform(_TransformFirstClosure(fn), lazy)

    def filter(self, fn):
        return SimpleDataset([self[i] for i in range(len(self))
                              if fn(self[i])])

    def take(self, count):
        count = min(count, len(self))
        return SimpleDataset([self[i] for i in range(count)])


class _TransformFirstClosure:
    def __init__(self, fn):
        self._fn = fn

    def __call__(self, x, *args):
        if args:
            return (self._fn(x),) + args
        return self._fn(x)


class _LazyTransformDataset(Dataset):
    def __init__(self, data, fn):
        self._data = data
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class SimpleDataset(Dataset):
    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class ArrayDataset(Dataset):
    """Zips several array-likes into (x, y, ...) samples."""

    def __init__(self, *args):
        if not args:
            raise MXNetError("needs at least one array")
        self._length = len(args[0])
        for i, a in enumerate(args):
            if len(a) != self._length:
                raise MXNetError(f"array {i} has length {len(a)} != "
                                 f"{self._length}")
        self._data = list(args)

    def __len__(self):
        return self._length

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(d[idx] for d in self._data)


class RecordFileDataset(Dataset):
    """Dataset over a RecordIO file: item ``i`` is the raw record of the
    ``i``-th key of its ``.idx``."""

    def __init__(self, filename):
        from ... import recordio
        idx_file = filename[:-4] + ".idx" if filename.endswith(".rec") \
            else filename + ".idx"
        self._record = recordio.MXIndexedRecordIO(idx_file, filename, "r")

    def __len__(self):
        return len(self._record.keys)

    def __getitem__(self, idx):
        return self._record.read_idx(self._record.keys[idx])
