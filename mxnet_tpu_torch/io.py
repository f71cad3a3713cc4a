"""Data iterators: the ``mx.io`` namespace.

Counterpart of ``mxnet_tpu/io.py``: a ``DataIter`` yields ``DataBatch``es
of ``NDArray``s on the CPU (the executor or the training loop copies them
onto its device), ``provide_data`` and ``provide_label`` describe them as
``DataDesc``s.  ``NDArrayIter`` walks in-memory arrays with ``shuffle``
and ``last_batch_handle`` ``pad`` (wrap to the front), ``discard`` or
``roll_over``, its shuffle order drawn from numpy's global stream.
``CSVIter``, ``LibSVMIter`` and ``MNISTIter`` read their files into
memory; ``ImageRecordIter`` decodes and augments a RecordIO file on host
threads, through the native io core (``native/io_core.cc``) or PIL;
``ResizeIter`` and ``PrefetchingIter`` wrap another iterator.
"""
from __future__ import annotations

import collections
import functools
import os
import queue as _queue
import struct
import threading
from typing import List, Optional, Sequence

import numpy as _np

from .base import MXNetError
from .context import cpu
from .ndarray import NDArray, array as nd_array
from .observability.registry import registry as _metrics_registry
from .observability.trace import span as _span

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "CSVIter",
           "MNISTIter", "ImageRecordIter", "PrefetchingIter", "ResizeIter",
           "LibSVMIter"]


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


class CSVIter(DataIter):
    """Iterate rows of CSV file(s) (MXNet: src/io/iter_csv.cc).

    ``data_csv``/``label_csv`` paths; ``data_shape`` is the per-example
    shape the flat row reshapes to."""

    def __init__(self, data_csv: str, data_shape: Sequence[int],
                 label_csv: Optional[str] = None,
                 label_shape: Sequence[int] = (1,), batch_size: int = 1,
                 round_batch: bool = True, dtype=_np.float32, **kwargs):
        super().__init__(batch_size)
        data = _np.loadtxt(data_csv, delimiter=",", dtype=dtype, ndmin=2)
        data = data.reshape((-1,) + tuple(data_shape))
        if label_csv is not None:
            label = _np.loadtxt(label_csv, delimiter=",", dtype=dtype,
                                ndmin=2).reshape((-1,) + tuple(label_shape))
        else:
            label = _np.zeros((data.shape[0],) + tuple(label_shape),
                              dtype=dtype)
        self._inner = NDArrayIter(
            {"data": data}, {"label": label}, batch_size,
            last_batch_handle="pad" if round_batch else "discard",
            label_name="label")

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()


class LibSVMIter(DataIter):
    """Iterate libsvm-format sparse rows (MXNet: src/io/iter_libsvm.cc).

    Rows are kept CSR-style and each batch is densified: the port has no
    sparse storage, so its batches are dense CPU ``NDArray``s where the
    JAX package's (and MXNet's) are ``CSRNDArray``s of the same values."""

    def __init__(self, data_libsvm: str, data_shape: Sequence[int],
                 label_libsvm: Optional[str] = None, batch_size: int = 1,
                 round_batch: bool = True, **kwargs):
        super().__init__(batch_size)
        self._num_col = int(_np.prod(data_shape))
        labels, indptr, indices, values = [], [0], [], []
        with open(data_libsvm) as f:
            for line in f:
                parts = line.strip().split()
                if not parts:
                    continue
                labels.append(float(parts[0]))
                for tok in parts[1:]:
                    i, v = tok.split(":")
                    indices.append(int(i))
                    values.append(float(v))
                indptr.append(len(indices))
        self._labels = _np.asarray(labels, dtype=_np.float32)
        self._indptr = _np.asarray(indptr, dtype=_np.int64)
        self._indices = _np.asarray(indices, dtype=_np.int64)
        self._values = _np.asarray(values, dtype=_np.float32)
        self._round_batch = round_batch
        self.num_data = len(labels)
        self.cursor = -batch_size

    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size, self._num_col))]

    @property
    def provide_label(self):
        return [DataDesc("label", (self.batch_size,))]

    def reset(self):
        self.cursor = -self.batch_size

    def _row(self, i: int) -> _np.ndarray:
        out = _np.zeros(self._num_col, dtype=_np.float32)
        lo, hi = self._indptr[i], self._indptr[i + 1]
        out[self._indices[lo:hi]] = self._values[lo:hi]
        return out

    def next(self) -> DataBatch:
        self.cursor += self.batch_size
        if self.cursor >= self.num_data:
            raise StopIteration
        sel = [(self.cursor + k) % self.num_data
               for k in range(self.batch_size)]
        pad = max(0, self.cursor + self.batch_size - self.num_data)
        if pad and not self._round_batch:
            raise StopIteration
        dense = _np.stack([self._row(i) for i in sel])
        return DataBatch([nd_array(dense, ctx=cpu())],
                         [nd_array(self._labels[sel], ctx=cpu())], pad=pad,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)


class MNISTIter(DataIter):
    """Read the idx-ubyte MNIST files (MXNet: src/io/iter_mnist.cc)."""

    def __init__(self, image: str, label: str, batch_size: int = 128,
                 shuffle: bool = True, flat: bool = False,
                 silent: bool = True, seed: int = 0, **kwargs):
        super().__init__(batch_size)
        imgs = self._read_idx(image)
        labs = self._read_idx(label)
        imgs = imgs.astype(_np.float32) / 255.0
        if flat:
            imgs = imgs.reshape(imgs.shape[0], -1)
        else:
            imgs = imgs.reshape(imgs.shape[0], 1, imgs.shape[1],
                                imgs.shape[2])
        self._inner = NDArrayIter({"data": imgs},
                                  {"softmax_label":
                                   labs.astype(_np.float32)},
                                  batch_size, shuffle=shuffle)

    @staticmethod
    def _read_idx(path: str) -> _np.ndarray:
        import gzip
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            zero, dt, ndim = struct.unpack(">HBB", f.read(4))
            shape = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
            return _np.frombuffer(f.read(), dtype=_np.uint8).reshape(shape)

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()


# ---------------------------------------------------------------------------
# ImageRecordIter: threaded decode+augment over .rec shards
# ---------------------------------------------------------------------------

class ImageRecordIter(DataIter):
    """Threaded JPEG decode + augment + batch over a RecordIO file.

    MXNet's src/io/iter_image_recordio_2.cc + image_aug_default.cc, the
    pipeline of the ImageNet recipe, with its knobs (``data_shape``,
    ``rand_crop``, ``rand_mirror``, ``mean_r/g/b``, ``std_r/g/b``,
    ``resize``, ``part_index``/``num_parts``, ``preprocess_threads``,
    ``prefetch_buffer``, ``round_batch``, ``label_width``).  The native
    path is the port's io core (``native/io_core.cc``: one ctypes call
    fills a batch on its own thread pool, without the GIL); the Python
    path decodes with PIL on a thread pool.  ``use_native=None`` takes the
    native path when it builds and quietly falls back otherwise;
    ``use_native=True`` raises instead.  A feeder thread queues finished
    batches into a bounded prefetch buffer; batches are CPU ``NDArray``s.
    """

    def __init__(self, path_imgrec: str, data_shape: Sequence[int],
                 batch_size: int, path_imgidx: Optional[str] = None,
                 shuffle: bool = False, rand_crop: bool = False,
                 rand_mirror: bool = False, resize: int = -1,
                 mean_r: float = 0.0, mean_g: float = 0.0,
                 mean_b: float = 0.0, std_r: float = 1.0,
                 std_g: float = 1.0, std_b: float = 1.0,
                 part_index: int = 0, num_parts: int = 1,
                 preprocess_threads: int = 4, prefetch_buffer: int = 4,
                 label_width: int = 1, round_batch: bool = True,
                 seed: int = 0, use_native: Optional[bool] = None,
                 scaled_decode: bool = True, **kwargs):
        super().__init__(batch_size)
        # native path only: DCT-domain scaled JPEG decode with a 2x
        # oversampling margin over the resize target; False decodes at
        # full size (what the Python path does)
        self.scaled_decode = scaled_decode
        self.data_shape = tuple(data_shape)
        if len(self.data_shape) != 3:
            raise MXNetError("data_shape must be (C, H, W)")
        self.path_imgrec = path_imgrec
        self.shuffle = shuffle
        self.rand_crop = rand_crop
        self.rand_mirror = rand_mirror
        self.resize = resize
        self.mean = _np.array([mean_r, mean_g, mean_b],
                              dtype=_np.float32).reshape(3, 1, 1)
        self.std = _np.array([std_r, std_g, std_b],
                             dtype=_np.float32).reshape(3, 1, 1)
        self.label_width = label_width
        self._round_batch = round_batch
        self.n_threads = max(1, preprocess_threads)
        self.prefetch = max(1, prefetch_buffer)
        self._rng = _np.random.default_rng(seed)
        self._native = None
        self._native_lib = None
        if use_native is not False:
            try:
                self._init_native(path_imgrec, path_imgidx, seed,
                                  part_index, num_parts)
            except MXNetError:
                if use_native:           # explicitly requested: surface it
                    raise
        if self._native is None:
            # pure-Python path: index the record file once
            self._offsets = self._scan_offsets(path_imgrec, path_imgidx)
            # distributed shard (MXNet: part_index/num_parts)
            shard = len(self._offsets) // num_parts
            lo = part_index * shard
            hi = len(self._offsets) if part_index == num_parts - 1 \
                else lo + shard
            self._offsets = self._offsets[lo:hi]
            self._order = _np.arange(len(self._offsets))
        self._stop = threading.Event()
        self._pool: List[threading.Thread] = []
        self._out: Optional[_queue.Queue] = None
        self.reset()

    def _init_native(self, path_imgrec, path_imgidx, seed,
                     part_index, num_parts) -> None:
        import ctypes
        from . import native
        lib = native.load_io()
        c, h, w = self.data_shape
        mean = (ctypes.c_float * 3)(*self.mean.ravel())
        std = (ctypes.c_float * 3)(*self.std.ravel())
        err = ctypes.create_string_buffer(512)
        # DCT-scaled decode floor: only the resize-shorter target may
        # set it (that stage renormalises the scale); without a resize a
        # scaled decode would widen the crop's field of view
        hint = 0
        if getattr(self, "scaled_decode", False) and self.resize > 0:
            hint = self.resize
        handle = lib.MXIOCreate(
            path_imgrec.encode(), (path_imgidx or "").encode(),
            self.batch_size, c, h, w, self.resize,
            int(self.rand_crop), int(self.rand_mirror), int(self.shuffle),
            int(self._round_batch), seed, mean, std, self.label_width,
            part_index, num_parts, self.n_threads, hint, err, len(err))
        if not handle:
            raise MXNetError(
                f"native ImageRecordIter: {err.value.decode()}")
        self._native_lib = lib
        self._native = handle

    @staticmethod
    def _scan_offsets(path: str, idx_path: Optional[str]) -> List[int]:
        if idx_path and os.path.isfile(idx_path):
            offs = []
            with open(idx_path) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    if len(parts) >= 2:
                        offs.append(int(parts[1]))
            return offs
        offs = []
        magic = struct.Struct("<II")
        with open(path, "rb") as f:
            pos = 0
            while True:
                head = f.read(8)
                if len(head) < 8:
                    break
                _, lrec = magic.unpack(head)
                length = lrec & ((1 << 29) - 1)
                offs.append(pos)
                skip = length + (4 - length % 4) % 4
                f.seek(skip, 1)
                pos += 8 + skip
        return offs

    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        shape = (self.batch_size,) if self.label_width == 1 \
            else (self.batch_size, self.label_width)
        return [DataDesc("label", shape)]

    # -- pipeline ----------------------------------------------------------
    def reset(self) -> None:
        self._shutdown()
        self._stop = threading.Event()
        self._out = _queue.Queue(maxsize=self.prefetch)
        if self._native is not None:
            self._native_lib.MXIOReset(self._native)
            n_batches = int(
                self._native_lib.MXIONumBatches(self._native))
            target = self._run_native
        else:
            if self.shuffle:
                self._rng.shuffle(self._order)
            n_batches = len(self._order) // self.batch_size
            tail = len(self._order) % self.batch_size
            if self._round_batch and tail:
                n_batches += 1      # final wrap-padded batch (pad set)
            # the epoch's crop and mirror seeds are drawn here, on the
            # caller's thread, after the shuffle: a departure from the
            # JAX package, whose feeder draws them as it goes, so that
            # what a feeder drew before a reset() stopped it changes the
            # next epoch's images there
            seeds = self._rng.integers(0, 2 ** 31,
                                       size=(n_batches, self.batch_size))
            target = functools.partial(self._run_pipeline,
                                       order=self._order.copy(),
                                       seeds=seeds)
        self._n_batches = n_batches
        self._consumed = 0
        feeder = threading.Thread(target=target,
                                  args=(self._stop, self._out, n_batches),
                                  daemon=True)
        feeder.start()
        self._pool = [feeder]

    def _run_native(self, stop: threading.Event, out: _queue.Queue,
                    n_batches: int) -> None:
        """Feeder loop over the io core: the ctypes call releases the GIL
        for the whole batch fill."""
        import ctypes
        try:
            lib, handle = self._native_lib, self._native
            c, h, w = self.data_shape
            fp = ctypes.POINTER(ctypes.c_float)
            for _ in range(n_batches):
                if stop.is_set():
                    return
                data = _np.empty((self.batch_size, c, h, w),
                                 dtype=_np.float32)
                label = _np.empty((self.batch_size, self.label_width),
                                  dtype=_np.float32)
                pad = lib.MXIONext(
                    handle, data.ctypes.data_as(fp),
                    label.ctypes.data_as(fp))
                if pad < 0:
                    msg = lib.MXIOLastError(handle).decode() \
                        if pad == -2 else "early epoch end"
                    raise MXNetError(f"native iter: {msg}")
                if self.label_width == 1:
                    label = label.reshape(self.batch_size)
                while not stop.is_set():
                    try:
                        out.put((data, label, pad), timeout=0.1)
                        break
                    except _queue.Full:
                        continue
        except BaseException as e:          # surface in next(), don't hang
            while not stop.is_set():
                try:
                    out.put(("__error__", e), timeout=0.1)
                    return
                except _queue.Full:
                    continue

    def _shutdown(self) -> None:
        if self._pool:
            self._stop.set()
            # drain so producers unblock
            try:
                while True:
                    self._out.get_nowait()
            except (_queue.Empty, AttributeError):
                pass
            for t in self._pool:
                if self._native is not None:
                    # the feeder may be inside MXIONext with the GIL
                    # released; Reset/Destroy on a handle another thread
                    # is mutating is a use-after-free — join for real
                    while t.is_alive():
                        t.join(timeout=5)
                else:
                    t.join(timeout=5)
            self._pool = []

    def _run_pipeline(self, stop: threading.Event, out: _queue.Queue,
                      n_batches: int, order, seeds) -> None:
        try:
            self._run_pipeline_inner(stop, out, n_batches, order, seeds)
        except BaseException as e:          # surface in next(), don't hang
            while not stop.is_set():
                try:
                    out.put(("__error__", e), timeout=0.1)
                    return
                except _queue.Full:
                    continue

    def _run_pipeline_inner(self, stop: threading.Event, out: _queue.Queue,
                            n_batches: int, order, seeds) -> None:
        bs = self.batch_size
        with open(self.path_imgrec, "rb") as f:
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(self.n_threads) as pool:
                for b in range(n_batches):
                    if stop.is_set():
                        return
                    sel = order[b * bs:(b + 1) * bs]
                    pad = bs - len(sel)
                    if pad:                  # round_batch: wrap to the front
                        sel = _np.concatenate([sel, order[:pad]])
                    raws = []
                    for i in sel:
                        f.seek(self._offsets[i])
                        head = f.read(8)
                        _, lrec = struct.unpack("<II", head)
                        raws.append(f.read(lrec & ((1 << 29) - 1)))
                    samples = list(pool.map(self._decode_one, raws,
                                            seeds[b]))
                    data = _np.stack([s[0] for s in samples])
                    label = _np.stack([s[1] for s in samples])
                    if self.label_width == 1:
                        label = label.reshape(bs)
                    while not stop.is_set():
                        try:
                            out.put((data, label, pad), timeout=0.1)
                            break
                        except _queue.Full:
                            continue

    def _decode_one(self, raw: bytes, seed: int):
        from .recordio import unpack_img
        header, img = unpack_img(raw)
        rng = _np.random.default_rng(seed)
        c, h, w = self.data_shape
        if img.ndim == 2:
            img = _np.stack([img] * 3, axis=-1)
        if self.resize > 0:
            img = _resize_shorter(img, self.resize)
        img = self._crop(img, h, w, rng)
        if self.rand_mirror and rng.random() < 0.5:
            img = img[:, ::-1]
        chw = img.astype(_np.float32).transpose(2, 0, 1)[:c]
        chw = (chw - self.mean) / self.std
        label = _np.atleast_1d(_np.asarray(header.label,
                                           dtype=_np.float32))
        if label.size < self.label_width:
            label = _np.pad(label, (0, self.label_width - label.size))
        return chw, label[:self.label_width]

    def _crop(self, img: _np.ndarray, h: int, w: int, rng) -> _np.ndarray:
        ih, iw = img.shape[:2]
        if ih < h or iw < w:
            img = _resize_shorter(img, max(h, w))
            ih, iw = img.shape[:2]
        if self.rand_crop:
            top = int(rng.integers(0, ih - h + 1))
            left = int(rng.integers(0, iw - w + 1))
        else:
            top, left = (ih - h) // 2, (iw - w) // 2
        return img[top:top + h, left:left + w]

    def next(self) -> DataBatch:
        if self._consumed >= self._n_batches:
            raise StopIteration
        # the consumer's wait: near zero when decode keeps ahead of the
        # step, large when the pipeline sets the pace
        with _span("io.record_batch_wait_us"):
            item = self._out.get()
        _metrics_registry().counter("io.record_batches").inc()
        if isinstance(item[0], str) and item[0] == "__error__":
            raise MXNetError(
                f"ImageRecordIter pipeline failed: {item[1]!r}") \
                from item[1]
        data, label, pad = item
        self._consumed += 1
        return DataBatch([nd_array(data, ctx=cpu())],
                         [nd_array(label, ctx=cpu())], pad=pad,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)

    def __del__(self):
        try:
            self._shutdown()
            if self._native is not None:
                self._native_lib.MXIODestroy(self._native)
                self._native = None
        except Exception:
            pass


def _resize_shorter(img: _np.ndarray, size: int) -> _np.ndarray:
    from PIL import Image
    h, w = img.shape[:2]
    if h < w:
        nh, nw = size, max(1, int(round(w * size / h)))
    else:
        nh, nw = max(1, int(round(h * size / w))), size
    return _np.asarray(Image.fromarray(img).resize((nw, nh),
                                                   Image.BILINEAR))


class ResizeIter(DataIter):
    """Resize another iterator to a fixed number of batches per epoch
    (MXNet: io.ResizeIter)."""

    def __init__(self, data_iter: DataIter, size: int,
                 reset_internal: bool = True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0

    @property
    def provide_data(self):
        return self.data_iter.provide_data

    @property
    def provide_label(self):
        return self.data_iter.provide_label

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def next(self) -> DataBatch:
        if self.cur >= self.size:
            raise StopIteration
        try:
            batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            batch = self.data_iter.next()
        self.cur += 1
        return batch


class PrefetchingIter(DataIter):
    """Run the wrapped iterator(s) on a background thread
    (MXNet: io.PrefetchingIter)."""

    def __init__(self, iters, rename_data=None, rename_label=None):
        if not isinstance(iters, (list, tuple)):
            iters = [iters]
        if len(iters) != 1:
            raise MXNetError("multi-iter prefetch not supported")
        super().__init__(iters[0].batch_size)
        self.iter = iters[0]
        self._queue: _queue.Queue = _queue.Queue(maxsize=2)
        self._thread: Optional[threading.Thread] = None
        self._start()

    @property
    def provide_data(self):
        return self.iter.provide_data

    @property
    def provide_label(self):
        return self.iter.provide_label

    def _start(self):
        def run():
            try:
                for batch in self.iter:
                    self._queue.put(batch)
            finally:
                self._queue.put(None)
        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def reset(self):
        if self._thread is not None:
            while self._queue.get() is not None:   # drain to epoch end
                pass
            self._thread.join()
        self._start()

    def next(self) -> DataBatch:
        batch = self._queue.get()
        if batch is None:
            self._thread.join()
            self._thread = None
            raise StopIteration
        return batch
