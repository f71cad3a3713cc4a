"""The port's iterators, native io core and ``gluon.data``, held against
the JAX package on the CPU with the same files and seeds.

- ``CSVIter``, ``LibSVMIter`` (dense in the port, ``CSRNDArray`` in the
  JAX package: the same values), ``MNISTIter``, ``ResizeIter`` and
  ``PrefetchingIter``: the same batches, exactly.
- ``ImageRecordIter(use_native=True)``: the port's io core against the
  JAX package's, bit for bit, over shuffle, random crop and mirror,
  resize, ``part_index``/``num_parts``, ``round_batch``, ``label_width``,
  ``scaled_decode``, ``RAWN`` records and a file without ``.idx``, two
  epochs.  The Python path against the JAX package's where it draws
  nothing (bit for bit), native against Python within the JAX package's
  own ``atol=1.0``; the port's Python path reproduces its random draws
  (a departure: the JAX package's feeder draws them as it goes).  An io
  core built without JPEG reads ``RAWN`` and fails on a JPEG record with
  an error naming the missing decoder.
- The departure ``read_idx``: 8 threads over 2,000 records of mixed
  sizes, and a 4-worker ``DataLoader`` over ``ImageRecordDataset``, get
  every record exactly.
- ``Dataset``/``transform_first``, every sampler, ``DataLoader`` with 0
  and 4 workers: the JAX package's batches, exactly; shards, the cursor
  across a re-shard, ``timeout`` naming the stalled worker, retries on
  transient errors only, the ``loader_stall``/``loader_error`` sites,
  the loader's metrics; the device stage on the CPU passes batches
  through in order.  The vision datasets (idx-ubyte and CIFAR pickles
  made from a seed, the seeded synthetic sets, record and folder
  datasets) and every transform with numpy's stream seeded alike.
"""
import ctypes
import gzip
import os
import pickle
import struct
import threading

import numpy as np
import pytest
from PIL import Image

import mxnet_tpu as mx
import mxnet_tpu_torch as pmx
from mxnet_tpu import faults as rfaults
from mxnet_tpu import recordio as rrec
from mxnet_tpu.gluon import data as rdata
from mxnet_tpu_torch import faults as pfaults
from mxnet_tpu_torch import native as pnative
from mxnet_tpu_torch import recordio as prec
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import data as pdata
from mxnet_tpu_torch.observability import registry as pregistry


def _np(x):
    if isinstance(x, (tuple, list)):
        return [_np(v) for v in x]
    if hasattr(x, "asnumpy"):
        return x.asnumpy()
    return np.asarray(x)


def _same(a, b):
    a, b = _np(a), _np(b)
    if isinstance(a, list):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            _same(u, v)
        return
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_array_equal(a, b)


def _batches(it):
    return [(_np(b.data), _np(b.label), b.pad) for b in it]


# ---- file iterators -----------------------------------------------------------

def test_csv_libsvm_mnist_iters_match(tmp_path):
    rng = np.random.default_rng(0)
    data = rng.random((10, 6), dtype=np.float32)
    label = np.arange(10, dtype=np.float32).reshape(10, 1)
    np.savetxt(tmp_path / "d.csv", data, delimiter=",")
    np.savetxt(tmp_path / "l.csv", label, delimiter=",")
    lines = []
    for i in range(7):
        cols = sorted(rng.choice(8, 3, replace=False))
        lines.append(f"{i % 2} " + " ".join(f"{c}:{rng.random():.4f}"
                                            for c in cols))
    (tmp_path / "d.libsvm").write_text("\n".join(lines) + "\n")
    imgs = rng.integers(0, 255, (9, 28, 28), dtype=np.uint8)
    with gzip.open(tmp_path / "img.gz", "wb") as f:
        f.write(struct.pack(">HBBIII", 0, 8, 3, 9, 28, 28) + imgs.tobytes())
    with open(tmp_path / "lab", "wb") as f:
        f.write(struct.pack(">HBBI", 0, 8, 1, 9) +
                (np.arange(9) % 10).astype(np.uint8).tobytes())
    for round_batch in (True, False):
        kw = dict(data_csv=str(tmp_path / "d.csv"), data_shape=(2, 3),
                  label_csv=str(tmp_path / "l.csv"), batch_size=4,
                  round_batch=round_batch)
        a, b = mx.io.CSVIter(**kw), pmx.io.CSVIter(**kw)
        for _ in range(2):
            ra, rb = _batches(a), _batches(b)
            assert len(rb) == (3 if round_batch else 2)
            _same([x[:2] for x in ra], [x[:2] for x in rb])
            assert [x[2] for x in ra] == [x[2] for x in rb]
        kw = dict(data_libsvm=str(tmp_path / "d.libsvm"), data_shape=(8,),
                  batch_size=3, round_batch=round_batch)
        ra = _batches(mx.io.LibSVMIter(**kw))
        rb = _batches(pmx.io.LibSVMIter(**kw))
        _same([x[:2] for x in ra], [x[:2] for x in rb])
    for flat in (False, True):
        runs = []
        for mod in (mx, pmx):
            np.random.seed(3)
            runs.append(_batches(mod.io.MNISTIter(
                image=str(tmp_path / "img.gz"), label=str(tmp_path / "lab"),
                batch_size=4, shuffle=True, flat=flat)))
        _same([x[:2] for x in runs[0]], [x[:2] for x in runs[1]])


def test_resize_and_prefetching_iters_match():
    data = np.arange(44, dtype=np.float32).reshape(11, 4)
    outs = []
    for mod in (mx, pmx):
        inner = mod.io.NDArrayIter(data, np.arange(11, dtype=np.float32),
                                   batch_size=3)
        resized = _batches(mod.io.ResizeIter(inner, 7))
        pre = mod.io.PrefetchingIter(mod.io.NDArrayIter(data, batch_size=4))
        first = _batches(pre)
        pre.reset()
        outs.append((resized, first, _batches(pre)))
    assert len(outs[1][0]) == 7 and len(outs[1][1]) == 3
    for r, p in zip(*outs):
        _same([x[:2] for x in r], [x[:2] for x in p])
    with pytest.raises(MXNetError):
        pmx.io.PrefetchingIter([1, 2])


# ---- ImageRecordIter ----------------------------------------------------------

def _rec(path, n=20, shape=(30, 34), label_width=1, seed=0, raw=False,
         idx=True):
    rng = np.random.default_rng(seed)
    prefix = str(path)
    w = prec.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w") \
        if idx else prec.MXRecordIO(prefix + ".rec", "w")
    for i in range(n):
        h, wd = shape[0] + i % 5, shape[1] + (3 * i) % 7
        img = rng.integers(0, 255, (h, wd, 3), dtype=np.uint8)
        lab = float(i % 10) if label_width == 1 else \
            np.arange(label_width, dtype=np.float32) + i
        hdr = prec.IRHeader(0, lab, i, 0)
        buf = prec.pack(hdr, prec._raw_payload(img)) if raw else \
            prec.pack_img(hdr, img, quality=90)
        if idx:
            w.write_idx(i, buf)
        else:
            w.write(buf)
    w.close()
    return prefix + ".rec", (prefix + ".idx" if idx else None)


NATIVE_CASES = {
    "augment": dict(shuffle=True, rand_crop=True, rand_mirror=True,
                    resize=28, mean_r=120.0, mean_g=110.0, mean_b=100.0,
                    std_r=60.0, std_g=55.0, std_b=50.0),
    "parts": dict(shuffle=True, rand_crop=True, part_index=1, num_parts=3),
    "no_round_batch": dict(round_batch=False, shuffle=True),
    "label_width": dict(label_width=3, rand_mirror=True),
    "scaled_decode": dict(resize=20, scaled_decode=True, rand_crop=True),
    "rawn": dict(shuffle=True, rand_crop=True, resize=26),
    "no_idx": dict(rand_mirror=True),
}


@pytest.mark.parametrize("case", sorted(NATIVE_CASES))
def test_native_record_iter_matches_bit_for_bit(tmp_path, case):
    kw = dict(NATIVE_CASES[case])
    shape = (96, 104) if case == "scaled_decode" else (30, 34)
    rec, idx = _rec(tmp_path / "a", n=22, shape=shape,
                    label_width=kw.get("label_width", 1),
                    raw=case == "rawn", idx=case != "no_idx")
    kw.update(data_shape=(3, 16, 16), batch_size=4, path_imgidx=idx,
              preprocess_threads=3, seed=7, use_native=True)
    kw.setdefault("scaled_decode", False)
    a = mx.io.ImageRecordIter(rec, **kw)
    b = pmx.io.ImageRecordIter(rec, **kw)
    assert b._native is not None
    for _ in range(2):
        ra, rb = _batches(a), _batches(b)
        assert len(rb) == len(ra) > 0
        for x, y in zip(ra, rb):
            assert x[2] == y[2]
            for u, v in zip(x[0] + x[1], y[0] + y[1]):
                assert u.shape == v.shape
                np.testing.assert_array_equal(u.view(np.uint32),
                                              v.view(np.uint32))


def test_python_record_iter_matches_and_reproduces(tmp_path):
    rec, idx = _rec(tmp_path / "a", n=13)
    kw = dict(data_shape=(3, 16, 16), batch_size=4, path_imgidx=idx,
              preprocess_threads=2, seed=3, resize=20, mean_r=10.0,
              std_b=3.0)
    a = mx.io.ImageRecordIter(rec, use_native=False, **kw)
    b = pmx.io.ImageRecordIter(rec, use_native=False, **kw)
    assert b._native is None
    for _ in range(2):
        ra, rb = _batches(a), _batches(b)
        assert len(rb) == 4 and rb[-1][2] == 3
        _same([x[:2] for x in ra], [x[:2] for x in rb])
    # the port draws an epoch's crop and mirror seeds before its feeder
    # starts, so two iterators with one seed give the same epochs
    kw.update(shuffle=True, rand_crop=True, rand_mirror=True)
    runs = [[x[:2] for x in _batches(pmx.io.ImageRecordIter(
        rec, use_native=False, **kw))] for _ in range(2)]
    _same(*runs)
    # native against Python at full decode, no resize: the JAX package's
    # own bound
    kw = dict(data_shape=(3, 24, 24), batch_size=6, path_imgidx=idx,
              preprocess_threads=2)
    bn = next(iter(pmx.io.ImageRecordIter(rec, use_native=True,
                                          scaled_decode=False, **kw)))
    bp = next(iter(pmx.io.ImageRecordIter(rec, use_native=False, **kw)))
    _same(bn.label, bp.label)
    np.testing.assert_allclose(bn.data[0].asnumpy(), bp.data[0].asnumpy(),
                               atol=1.0)


def test_io_core_without_jpeg_reads_rawn_and_names_the_missing_decoder(
        tmp_path, monkeypatch):
    lib = ctypes.CDLL(str(pnative._build(pnative.NO_JPEG)))
    pnative._bind(lib)
    assert lib.MXIOHasJpeg() == 0
    # the default core decodes JPEG wherever its libjpeg build exists
    assert pnative.has_jpeg() == pnative._target(pnative.JPEG_LIBS).exists()
    monkeypatch.setattr(pnative, "load_io", lambda: lib)
    kw = dict(data_shape=(3, 16, 16), batch_size=4, use_native=True,
              seed=1)
    raw, _ = _rec(tmp_path / "raw", n=8, raw=True)
    ref = pmx.io.ImageRecordIter(raw, **kw)
    monkeypatch.undo()
    full = pmx.io.ImageRecordIter(raw, **kw)
    _same([x[:2] for x in _batches(ref)], [x[:2] for x in _batches(full)])
    monkeypatch.setattr(pnative, "load_io", lambda: lib)
    jpeg, _ = _rec(tmp_path / "jpeg", n=8)
    it = pmx.io.ImageRecordIter(jpeg, **kw)
    with pytest.raises(MXNetError, match="without a JPEG decoder"):
        next(iter(it))


def test_native_build_lands_in_build_dir():
    so = pnative._target(pnative.JPEG_LIBS)
    assert so.parent == pnative.BUILD_DIR and so.name.startswith("libmxio-")
    assert pnative.io_available()
    assert pnative.SOURCE.parent != pnative.BUILD_DIR


# ---- the departure: indexed reads across threads ------------------------------

def test_indexed_reads_are_thread_safe_unlike_jax(tmp_path):
    rng = np.random.default_rng(0)
    sizes = rng.integers(1, 64 * 1024, 2000)
    payloads = [rng.integers(0, 256, s, dtype=np.uint8).tobytes()
                for s in sizes]
    prefix = str(tmp_path / "mixed")
    w = prec.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    for i, p in enumerate(payloads):
        w.write_idx(i, p)
    w.close()
    reader = prec.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "r")
    bad = []

    def work(t):
        order = np.random.default_rng(t).permutation(len(payloads))
        for i in order:
            if reader.read_idx(int(i)) != payloads[i]:
                bad.append((t, int(i)))

    threads = [threading.Thread(target=work, args=(t,)) for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not bad
    # a 4-worker loader over one ImageRecordDataset: every record exactly
    rec, _ = _rec(tmp_path / "img", n=64, shape=(9, 11), raw=True)
    ds = pdata.vision.ImageRecordDataset(rec)
    seen = {}
    loader = pdata.DataLoader(ds.transform_first(lambda x: x.asnumpy()[:5, :5]),
                              batch_size=4, num_workers=4, shuffle=True)
    for x, y in loader:
        for xi, yi in zip(x.asnumpy(), y.asnumpy()):
            seen.setdefault(float(yi), []).append(xi)
    whole = [prec.unpack_img(ds._record.read_idx(i))
             for i in range(len(ds))]
    assert sum(len(v) for v in seen.values()) == 64
    for hdr, img in whole:
        assert any(np.array_equal(img[:5, :5], x) for x in seen[hdr.label])


# ---- gluon.data ---------------------------------------------------------------

def test_datasets_and_samplers_match():
    x = np.arange(30, dtype=np.float32).reshape(10, 3)
    y = np.arange(10, dtype=np.float32)
    for mod in (rdata, pdata):
        assert len(mod.ArrayDataset(x, y)) == 10
    a = rdata.ArrayDataset(x, y).transform_first(lambda v: v * 2)
    b = pdata.ArrayDataset(x, y).transform_first(lambda v: v * 2)
    _same([a[i] for i in range(10)], [b[i] for i in range(10)])
    _same(pdata.SimpleDataset(list(range(5))).transform(
        lambda v: v + 1, lazy=False)[4], 5)
    assert len(pdata.ArrayDataset(x).filter(lambda v: v[0] > 10)) == 6
    assert len(pdata.ArrayDataset(x).take(3)) == 3
    with pytest.raises(MXNetError):
        pdata.ArrayDataset(x, y[:3])
    for last in ("keep", "discard", "rollover"):
        runs = []
        for mod in (rdata, pdata):
            np.random.seed(5)
            bs = mod.BatchSampler(mod.RandomSampler(10), 3, last)
            runs.append([list(bs), list(bs), len(bs)])
        assert runs[0] == runs[1]
    assert list(pdata.FilterSampler(lambda v: v[0] % 2 == 0,
                                    pdata.ArrayDataset(x))) == [0, 2, 4, 6,
                                                                8]
    assert list(pdata.SequentialSampler(3, start=2)) == [2, 3, 4]


@pytest.mark.parametrize("workers", [0, 4])
def test_dataloader_matches_the_jax_package(workers):
    x = np.random.default_rng(1).random((26, 2, 3), dtype=np.float32)
    y = np.arange(26) % 4
    runs = []
    for mod, nd in ((rdata, mx.nd), (pdata, pmx.nd)):
        np.random.seed(2)
        ds = mod.ArrayDataset(nd.array(x, ctx=mx.cpu() if nd is mx.nd
                                       else "cpu"), y)
        loader = mod.DataLoader(ds, batch_size=4, shuffle=True,
                                num_workers=workers, last_batch="discard")
        runs.append([_np(b) for ep in range(2) for b in loader])
        assert len(loader) == 6
    assert len(runs[1]) == 12
    _same(*runs)
    b = next(iter(pdata.DataLoader(pdata.ArrayDataset(x, y), batch_size=3)))
    assert b[0].context == pmx.cpu() and b[1].dtype == np.int64
    with pytest.raises(MXNetError):
        pdata.DataLoader(x, batch_size=2, shuffle=True,
                         sampler=pdata.SequentialSampler(26))


class _Counting:
    def __init__(self, n):
        self.n, self.reads = n, 0

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        self.reads += 1
        return np.float32([i])


def test_dataloader_shards_and_cursor_across_a_reshard():
    ds = [np.float32([i]) for i in range(24)]
    for s, first in ((0, 0), (1, 2), (2, 4)):
        dl = pdata.DataLoader(ds, batch_size=2, num_shards=3, shard_index=s)
        assert len(dl) == 4
        assert [int(b.asnumpy()[0, 0]) for b in dl] == \
            [first + 6 * k for k in range(4)]
    dl = pdata.DataLoader(_Counting(48), batch_size=2, num_shards=3,
                          shard_index=0)
    it = iter(dl)
    for _ in range(4):
        next(it)
    state = dl.state_dict()
    assert state == {"epoch": 1, "batch": 4, "num_shards": 3,
                     "global": 12}
    for shard, k, start, ds_ in ((1, 2, 26, _Counting(48)),
                                 (0, 2, 24, _Counting(48))):
        dl2 = pdata.DataLoader(ds_, batch_size=2, num_shards=k,
                               shard_index=shard, num_workers=2)
        dl2.load_state_dict(state)
        vals = [int(b.asnumpy()[0, 0]) for b in dl2]
        assert vals[0] == start and ds_.reads == len(vals) * 2
    dl3 = pdata.DataLoader(_Counting(48), batch_size=2, num_shards=2,
                           shard_index=0)
    dl3.load_state_dict({"epoch": 1, "global": 9})
    assert int(next(iter(dl3)).asnumpy()[0, 0]) == 20
    assert dl3.state_dict()["global"] == 11
    dl4 = pdata.DataLoader(_Counting(48), batch_size=2, num_shards="dist")
    assert len(dl4) == 24
    with pytest.raises(MXNetError):
        pdata.DataLoader(ds, batch_size=2, num_shards=2, shard_index=2)
    with pytest.raises(MXNetError):
        pdata.DataLoader(ds, batch_size=2, shard_index=1)


class _FlakyFirstBatch:
    def __init__(self):
        self._failed = False

    def __len__(self):
        return 8

    def __getitem__(self, i):
        if i == 0 and not self._failed:
            self._failed = True
            raise OSError("flaky read")
        return np.full((2,), i, np.float32)


def test_dataloader_faults_retries_and_timeout():
    data = [np.full((2,), i, np.float32) for i in range(8)]
    pfaults.set_fault_plan("loader_stall@1:3.0")
    try:
        dl = pdata.DataLoader(data, batch_size=2, num_workers=1,
                              timeout=1.0)
        with pytest.raises(MXNetError,
                           match=r"waiting for batch 0.*stalled workers"):
            list(dl)
    finally:
        pfaults.set_fault_plan(None)
    got = list(pdata.DataLoader(_FlakyFirstBatch(), batch_size=2,
                                num_workers=2, worker_retries=1))
    assert len(got) == 4 and got[3].asnumpy()[1, 0] == 7.0
    with pytest.raises(MXNetError, match=r"worker .* failed on batch 0"):
        list(pdata.DataLoader(_FlakyFirstBatch(), batch_size=2,
                              num_workers=2))

    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            raise ValueError("broken")

    with pytest.raises(MXNetError, match=r"after 1 attempt"):
        list(pdata.DataLoader(Broken(), batch_size=2, num_workers=1,
                              worker_retries=3))
    before = pregistry().counter("loader.worker_retries").n
    pfaults.set_fault_plan("loader_error@3")
    try:
        assert len(list(pdata.DataLoader(data, batch_size=2, num_workers=2,
                                         worker_retries=1))) == 4
        assert pfaults.active_plan().empty
    finally:
        pfaults.set_fault_plan(None)
    assert pregistry().counter("loader.worker_retries").n == before + 1
    plan = pfaults.FaultPlan("loader_error@2x2;loader_stall@1:0.5")
    assert [(e.kind, e.index, e.arg) for e in plan.pending()] == \
        [(e.kind, e.index, e.arg) for e in rfaults.FaultPlan(
            "loader_error@2x2;loader_stall@1:0.5").pending()]
    with pytest.raises(MXNetError, match="bad MXTPU_FAULT_PLAN"):
        pfaults.FaultPlan("nope")
    calls = []
    with pytest.raises(pfaults.TransientFault):
        pfaults.retry_call(lambda: calls.append(1) or (_ for _ in ()).throw(
            pfaults.TransientFault("x")), retries=2, base_delay=0,
            jitter=0)
    assert len(calls) == 3


def test_dataloader_metrics_and_device_stage_on_the_cpu():
    reg = pregistry()
    base = reg.counter("loader.batches").n
    builds = reg.histogram("loader.batch_build_us").count
    data = np.arange(64, dtype=np.float32).reshape(32, 2)
    ds = pdata.ArrayDataset(pmx.nd.array(data, ctx="cpu"),
                            pmx.nd.array(np.arange(32), ctx="cpu"))
    loader = pdata.DataLoader(ds, batch_size=4, num_workers=2, prefetch=4,
                              device_prefetch=2)
    with pmx.cpu():
        got = [b for b in loader]
    assert len(got) == 8
    _same([b[0] for b in got], [data[i:i + 4] for i in range(0, 32, 4)])
    assert reg.counter("loader.batches").n - base == 8
    assert reg.histogram("loader.batch_build_us").count - builds == 8
    snap = reg.snapshot()
    assert 0.0 <= snap["loader.prefetch_depth"] <= 4.0
    assert snap["loader.prefetch_capacity"] == 4.0
    assert snap["loader.device_buffer_depth"] == 0.0
    assert snap["loader.device_put_us"]["count"] >= 8
    trace = loader.consume_trace()
    assert set(trace) == {"wait_us", "wait_end", "device_put_us"}
    assert trace["wait_us"] > 0 and loader.consume_trace()["wait_us"] == 0
    pdata.dataloader.set_device_prefetch_override(0)
    pdata.dataloader.set_prefetch_override(3)
    try:
        assert loader._resolve_device_depth() == 0
        with pmx.cpu():
            assert len(list(loader)) == 8
        assert reg.snapshot()["loader.prefetch_capacity"] == 3.0
    finally:
        pdata.dataloader.set_device_prefetch_override(None)
        pdata.dataloader.set_prefetch_override(None)
    seen = []
    loader.set_device_put_fn(lambda b: seen.append(1) or b)
    with pmx.cpu():
        assert len(list(loader)) == 8 and len(seen) == 8
    assert loader.device_put_fn is not None
    # pin_memory without a card leaves the batches as they are
    b = next(iter(pdata.DataLoader(ds, batch_size=4, pin_memory=True)))
    assert b[0].context == pmx.cpu()


# ---- vision -------------------------------------------------------------------

def _idx_files(root, n=12, seed=0):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 255, (n, 28, 28), dtype=np.uint8)
    labs = rng.integers(0, 10, n).astype(np.uint8)
    os.makedirs(root, exist_ok=True)
    with gzip.open(os.path.join(root, "train-images-idx3-ubyte.gz"),
                   "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + imgs.tobytes())
    with open(os.path.join(root, "train-labels-idx1-ubyte"), "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labs.tobytes())
    return imgs, labs


def test_vision_datasets_match(tmp_path):
    imgs, labs = _idx_files(str(tmp_path / "mnist"))
    a = rdata.vision.MNIST(root=str(tmp_path / "mnist"))
    b = pdata.vision.MNIST(root=str(tmp_path / "mnist"))
    assert len(b) == 12
    _same([a[i] for i in range(12)], [b[i] for i in range(12)])
    assert b[0][0].context == pmx.cpu()
    base = tmp_path / "cifar" / "cifar-10-batches-py"
    os.makedirs(base)
    rng = np.random.default_rng(1)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(base / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 255, (3, 3072),
                                               dtype=np.uint8),
                         b"labels": list(rng.integers(0, 10, 3))}, f)
    for train in (True, False):
        a = rdata.vision.CIFAR10(root=str(tmp_path / "cifar"), train=train)
        b = pdata.vision.CIFAR10(root=str(tmp_path / "cifar"), train=train)
        assert len(b) == (15 if train else 3)
        _same([a[i] for i in range(len(a))], [b[i] for i in range(len(b))])
    with pytest.warns(UserWarning, match="seeded synthetic"):
        b = pdata.vision.FashionMNIST(root=str(tmp_path / "none"),
                                      train=False,
                                      transform=lambda x, y: (x, y + 1))
    a = rdata.vision.FashionMNIST(root=str(tmp_path / "none"), train=False,
                                  transform=lambda x, y: (x, y + 1))
    assert len(b) == 10000
    _same([a[i] for i in (0, 9999)], [b[i] for i in (0, 9999)])


def test_record_and_folder_datasets_match(tmp_path):
    rec, _ = _rec(tmp_path / "r", n=6)
    for cls in (rdata.RecordFileDataset, pdata.RecordFileDataset):
        assert len(cls(rec)) == 6
    assert rdata.RecordFileDataset(rec)[3] == pdata.RecordFileDataset(rec)[3]
    a = rdata.vision.ImageRecordDataset(rec)
    b = pdata.vision.ImageRecordDataset(rec)
    _same([a[i] for i in range(6)], [b[i] for i in range(6)])
    root = tmp_path / "folder"
    rng = np.random.default_rng(2)
    for cls in ("b", "a"):
        os.makedirs(root / cls)
        for i in range(2):
            Image.fromarray(rng.integers(0, 255, (8, 9, 3), dtype=np.uint8)
                            ).save(root / cls / f"{i}.png")
    (root / "notes.txt").write_text("not a class")
    a = rdata.vision.ImageFolderDataset(str(root))
    b = pdata.vision.ImageFolderDataset(str(root))
    assert b.synsets == ["a", "b"] and len(b) == 4
    _same([a[i] for i in range(4)], [b[i] for i in range(4)])


def _transforms(mod):
    t = mod.vision.transforms
    return [
        t.Compose([t.RandomResizedCrop(12), t.RandomFlipLeftRight(),
                   t.RandomFlipTopBottom(), t.ToTensor(),
                   t.Normalize([0.4, 0.5, 0.6], [0.2, 0.25, 0.3])]),
        t.Compose([t.Resize((11, 9)), t.CenterCrop(7), t.Cast("float32"),
                   t.RandomColorJitter(0.3, 0.3, 0.3, 0.2),
                   t.RandomLighting(0.1)]),
        t.Compose([t.CropResize(2, 3, 10, 8, size=6), t.RandomBrightness(
            0.4), t.RandomContrast(0.4), t.RandomSaturation(0.4),
            t.RandomHue(0.3), t.ToTensor()]),
        t.Compose([t.Resize(5)]),
    ]


@pytest.mark.parametrize("k", range(4))
def test_vision_transforms_match(k):
    rng = np.random.default_rng(k)
    imgs = [rng.integers(0, 255, (20 + i, 17, 3), dtype=np.uint8)
            for i in range(3)]
    outs = []
    for mod, nd in ((rdata, mx.nd), (pdata, pmx.nd)):
        np.random.seed(k)
        chain = _transforms(mod)[k]
        outs.append([_np(chain(nd.array(im, dtype="uint8") if nd is mx.nd
                               else nd.array(im, ctx="cpu", dtype="uint8"),
                               7)) for im in imgs])
    for (ra, rl), (pa, pl) in zip(*outs):
        assert pa.dtype == ra.dtype and pa.shape == ra.shape
        np.testing.assert_allclose(pa, ra, rtol=1e-6, atol=1e-5)
        assert pl == rl == 7
    with pytest.raises(MXNetError, match="exceeds"):
        pdata.vision.transforms.CropResize(10, 0, 20, 5)(
            np.zeros((8, 8, 3), np.uint8))
