"""RecordIO, ``im2rec``, ``mx.nd.image`` and ``mx.image`` of the port,
held against the JAX package on the CPU with the same numpy inputs.

- ``.rec``/``.idx`` written by either package are byte for byte the same
  (JPEG and ``RAWN`` payloads, scalar and vector labels) and each reads
  the other's; ``im2rec`` on a seeded class-per-folder tree writes the
  same ``.lst``/``.rec``/``.idx`` (and its ``main`` does too).
- Every ``nd.image`` op: the deterministic ones within 1e-6 (resize on
  values in [0, 1], nearest and the antialiased triangle filter, up and
  down); the random ones with the drawn factor fixed on both sides
  within 1e-6 relative (1e-4 on pixel values up to 255); and each random
  op reproducible under ``mx.random.seed``.
- Every ``mx.image`` augmenter, ``CreateAugmenter`` and ``ImageIter``,
  the detection augmenters with their boxes, ``CreateDetAugmenter`` and
  ``ImageDetIter``, with Python's ``random`` and numpy's global stream
  seeded alike: equal to the JAX package's (1e-5 on float outputs, 0 on
  uint8 and on boxes' float32 arithmetic).
"""
import os
import random

import numpy as np
import pytest
from PIL import Image

import mxnet_tpu as mx
import mxnet_tpu_torch as pmx
from mxnet_tpu import image as rimg
from mxnet_tpu import recordio as rrec
from mxnet_tpu.ndarray import ops_image as r_ops_image
from mxnet_tpu.tools import im2rec as rim2rec
from mxnet_tpu_torch import image as pimg
from mxnet_tpu_torch import recordio as prec
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ndarray import ops_image as p_ops_image
from mxnet_tpu_torch.tools import im2rec as pim2rec

TOL = 1e-6


def _images(n=6, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 255, (20 + 3 * i, 30 - i, 3), dtype=np.uint8)
            for i in range(n)]


def _write(mod, prefix, imgs, raw):
    w = mod.MXIndexedRecordIO(f"{prefix}.idx", f"{prefix}.rec", "w")
    for i, img in enumerate(imgs):
        label = float(i) if i % 2 else np.arange(3, dtype=np.float32) + i
        hdr = mod.IRHeader(0, label, i, 7)
        buf = mod.pack(hdr, prec._raw_payload(img)) if raw else \
            mod.pack_img(hdr, img, quality=90)
        w.write_idx(i, buf)
    w.close()


@pytest.mark.parametrize("raw", [False, True], ids=["jpeg", "rawn"])
def test_record_files_are_byte_identical_and_cross_read(tmp_path, raw):
    imgs = _images()
    _write(rrec, str(tmp_path / "r"), imgs, raw)
    _write(prec, str(tmp_path / "p"), imgs, raw)
    for ext in ("rec", "idx"):
        assert (tmp_path / f"r.{ext}").read_bytes() == \
            (tmp_path / f"p.{ext}").read_bytes()
    for reader, writer in ((prec, "r"), (rrec, "p")):
        rd = reader.MXIndexedRecordIO(str(tmp_path / f"{writer}.idx"),
                                      str(tmp_path / f"{writer}.rec"), "r")
        for i in reversed(rd.keys):
            hdr, img = reader.unpack_img(rd.read_idx(i))
            assert hdr.id == i and hdr.id2 == 7
            np.testing.assert_array_equal(
                np.atleast_1d(hdr.label),
                [float(i)] if i % 2 else np.arange(3) + i)
            if raw:
                np.testing.assert_array_equal(img, imgs[i])
            else:
                assert img.shape == imgs[i].shape
        rd.close()
    seq = prec.MXRecordIO(str(tmp_path / "r.rec"), "r")
    n = 0
    while seq.read() is not None:
        n += 1
    assert n == len(imgs)


def test_record_reader_errors(tmp_path):
    p = tmp_path / "bad.rec"
    p.write_bytes(b"\x00" * 16)
    with pytest.raises(MXNetError, match="bad record magic"):
        prec.MXRecordIO(str(p), "r").read()
    with pytest.raises(MXNetError, match="flag"):
        prec.MXRecordIO(str(p), "x")


def _tree(root):
    rng = np.random.default_rng(3)
    for cls in ("bird", "cat", "dog"):
        os.makedirs(os.path.join(root, cls))
        for i in range(3):
            Image.fromarray(rng.integers(0, 255, (24, 28, 3),
                                         dtype=np.uint8)).save(
                os.path.join(root, cls, f"{i}.jpg"), quality=92)


def test_im2rec_writes_the_jax_packages_files(tmp_path):
    root = str(tmp_path / "imgs")
    _tree(root)
    for mod, name in ((rim2rec, "r"), (pim2rec, "p")):
        prefix = str(tmp_path / name)
        mod.make_list(prefix, root, shuffle=True, seed=5)
        mod.pack(prefix, root, quality=90, resize=20)
    for ext in ("lst", "rec", "idx"):
        assert (tmp_path / f"r.{ext}").read_bytes() == \
            (tmp_path / f"p.{ext}").read_bytes(), ext
    pim2rec.main([str(tmp_path / "m"), root, "--quality", "80"])
    rim2rec.main([str(tmp_path / "n"), root, "--quality", "80"])
    assert (tmp_path / "m.rec").read_bytes() == \
        (tmp_path / "n.rec").read_bytes()
    entries = list(pim2rec.read_list(str(tmp_path / "p.lst")))
    assert sorted(lab[0] for _, lab, _ in entries) == [0.0] * 3 + \
        [1.0] * 3 + [2.0] * 3


# ---- nd.image ---------------------------------------------------------------

def _hwc(shape=(7, 9, 3), seed=0):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


DETERMINISTIC = [
    ("to_tensor", {}, "uint8"),
    ("to_tensor", {}, "uint8_batch"),
    ("normalize", {"mean": (0.1, 0.2, 0.3), "std": (0.5, 0.6, 0.7)}, "chw"),
    ("normalize", {"mean": (0.1, 0.2, 0.3), "std": (0.5, 0.6, 0.7)},
     "nchw"),
    ("flip_left_right", {}, "hwc"),
    ("flip_top_bottom", {}, "batch"),
    ("resize", {"size": 4}, "hwc"),
    ("resize", {"size": (13, 5)}, "hwc"),
    ("resize", {"size": 12}, "hwc"),
    ("resize", {"size": 5, "keep_ratio": True}, "batch"),
    ("resize", {"size": (4, 11), "interp": 0}, "hwc"),
    ("resize", {"size": 6}, "uint8"),
    ("crop", {"x": 1, "y": 2, "width": 5, "height": 3}, "batch"),
    ("adjust_lighting", {"alpha": (0.1, -0.2, 0.3)}, "hwc"),
]


def _input(kind):
    if kind == "uint8":
        return (_hwc() * 255).astype(np.uint8)
    if kind == "uint8_batch":
        return (_hwc((2, 7, 9, 3)) * 255).astype(np.uint8)
    if kind == "chw":
        return _hwc((3, 7, 9))
    if kind == "nchw":
        return _hwc((2, 3, 7, 9))
    if kind == "batch":
        return _hwc((2, 7, 9, 3))
    return _hwc()


@pytest.mark.parametrize("op,kw,kind", DETERMINISTIC,
                         ids=[f"{o}-{k}-{i}" for i, (o, _, k) in
                              enumerate(DETERMINISTIC)])
def test_nd_image_deterministic_ops_match(op, kw, kind):
    x = _input(kind)
    ref = getattr(mx.nd.image, op)(mx.nd.array(x, dtype=x.dtype),
                                   **kw).asnumpy()
    with pmx.cpu():
        out = getattr(pmx.nd.image, op)(pmx.nd.array(x, dtype=x.dtype),
                                        **kw).asnumpy()
    assert out.dtype == ref.dtype and out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=TOL)


RANDOM = [("random_flip_left_right", {}, 0.3),
          ("random_flip_left_right", {}, 0.7),
          ("random_flip_top_bottom", {}, 0.2),
          ("random_brightness", {"min_factor": 0.5, "max_factor": 1.5}, 1.3),
          ("random_contrast", {"min_factor": 0.5, "max_factor": 1.5}, 0.7),
          ("random_saturation", {"min_factor": 0.5, "max_factor": 1.5},
           1.2),
          ("random_hue", {"min_factor": -0.4, "max_factor": 0.4}, 0.25)]


@pytest.mark.parametrize("op,kw,factor", RANDOM,
                         ids=[f"{o}-{f}" for o, _, f in RANDOM])
def test_nd_image_random_ops_match_with_the_factor_fixed(monkeypatch, op,
                                                         kw, factor):
    monkeypatch.setattr(r_ops_image, "_host_uniform", lambda lo, hi: factor)
    monkeypatch.setattr(p_ops_image, "_host_uniform", lambda lo, hi: factor)
    x = _input("batch" if "contrast" in op else "hwc") * 255
    ref = getattr(mx.nd.image, op)(mx.nd.array(x), **kw).asnumpy()
    with pmx.cpu():
        out = getattr(pmx.nd.image, op)(pmx.nd.array(x), **kw).asnumpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("op,kw", [(o, k) for o, k, _ in RANDOM[::2]])
def test_nd_image_random_ops_reproduce_under_mx_random_seed(op, kw):
    x = pmx.nd.array(_input("hwc") * 255, ctx="cpu")
    runs = []
    for _ in range(2):
        pmx.random.seed(11)
        runs.append([getattr(pmx.nd.image, op)(x, **kw).asnumpy()
                     for _ in range(6)])
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)
    if op != "random_flip_top_bottom":
        assert any(not np.array_equal(runs[0][0], r) for r in runs[0][1:])


def test_nd_image_registry_and_errors():
    names = [n for n in pmx.nd.list_ops() if n.startswith("_image_")]
    assert len(pmx.nd.list_ops()) == 174 and len(names) == 13
    assert set(names) <= set(mx.nd.list_ops())
    with pmx.cpu():
        x = pmx.nd.array(_hwc())
        with pytest.raises(MXNetError, match="outside"):
            pmx.nd.image.crop(x, x=5, y=0, width=9, height=2)
        with pytest.raises(MXNetError, match="float input"):
            pmx.nd.image.adjust_lighting(pmx.nd.array(
                _input("uint8"), dtype="uint8"), alpha=(0.1, 0.1, 0.1))


# ---- mx.image -----------------------------------------------------------------

def _seed(s):
    random.seed(s)
    np.random.seed(s)


def _both(make, arr, seed=4, det_label=None):
    """``make(mod)`` -> an augmenter of each package, applied to ``arr``
    (and a detection label) with both random streams seeded alike."""
    outs = []
    for mod in (rimg, pimg):
        _seed(seed)
        aug = make(mod)
        if det_label is None:
            outs.append(aug.apply_np(arr.copy()))
        else:
            outs.append(aug.apply_np(arr.copy(), det_label.copy()))
    return outs


AUGS = {
    "resize": lambda m: m.ResizeAug(17),
    "force_resize": lambda m: m.ForceResizeAug((15, 11), interp=2),
    "center_crop": lambda m: m.CenterCropAug((14, 12)),
    "random_crop": lambda m: m.RandomCropAug((14, 12)),
    "random_sized_crop": lambda m: m.RandomSizedCropAug(
        (16, 16), (0.3, 1.0), (0.75, 1.33)),
    "flip": lambda m: m.HorizontalFlipAug(0.6),
    "cast": lambda m: m.CastAug(),
    "normalize": lambda m: m.ColorNormalizeAug([120.0, 110.0, 100.0],
                                               [60.0, 55.0, 50.0]),
    "brightness": lambda m: m.BrightnessJitterAug(0.3),
    "contrast": lambda m: m.ContrastJitterAug(0.3),
    "saturation": lambda m: m.SaturationJitterAug(0.3),
    "hue": lambda m: m.HueJitterAug(0.3),
    "color_jitter": lambda m: m.ColorJitterAug(0.2, 0.2, 0.2),
    "lighting": lambda m: m.LightingAug(0.1, [55.46, 4.794, 1.148],
                                        np.eye(3)),
    "gray": lambda m: m.RandomGrayAug(0.9),
    "create": lambda m: m.CreateAugmenter(
        (3, 16, 16), resize=20, rand_crop=True, rand_mirror=True,
        mean=True, std=True, brightness=0.1, contrast=0.1, saturation=0.1,
        hue=0.1, pca_noise=0.1, rand_gray=0.3),
    "create_rand_resize": lambda m: m.CreateAugmenter(
        (3, 16, 16), rand_resize=True, mean=np.array([1.0, 2.0, 3.0])),
}


class _Chain:
    def __init__(self, augs):
        self.augs = augs

    def apply_np(self, arr):
        for a in self.augs:
            arr = a.apply_np(arr)
        return arr


@pytest.mark.parametrize("name", sorted(AUGS))
@pytest.mark.parametrize("seed", [4, 9])
def test_image_augmenters_match(name, seed):
    arr = _images(1, seed=seed)[0]
    make = AUGS[name]
    ref, out = _both(lambda m: _Chain(make(m)) if name.startswith("create")
                     else make(m), arr, seed)
    assert out.dtype == ref.dtype and out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-5)


def test_image_functions_and_ndarray_surface(tmp_path):
    arr = _images(1)[0]
    path = str(tmp_path / "a.png")
    Image.fromarray(arr).save(path)
    with open(path, "rb") as f:
        buf = f.read()
    np.testing.assert_array_equal(pimg.imdecode(buf).asnumpy(), arr)
    np.testing.assert_array_equal(pimg.imread(path).asnumpy(), arr)
    np.testing.assert_array_equal(pimg.imdecode(buf, to_rgb=False)
                                  .asnumpy(), arr[:, :, ::-1])
    img = pimg.imread(path)
    assert img.context == pmx.cpu()
    for name, args in (("imresize", (13, 9)), ("resize_short", (11,)),
                       ("fixed_crop", (2, 3, 10, 8, (6, 5))),
                       ("color_normalize", ([1.0, 2.0, 3.0], [2.0] * 3))):
        ref = getattr(rimg, name)(mx.nd.array(arr, dtype="uint8"), *args)
        out = getattr(pimg, name)(img, *args)
        np.testing.assert_allclose(out.asnumpy(), ref.asnumpy(), atol=1e-5)
    for name in ("center_crop", "random_crop"):
        _seed(2)
        ref, rbox = getattr(rimg, name)(mx.nd.array(arr, dtype="uint8"),
                                        (10, 8))
        _seed(2)
        out, pbox = getattr(pimg, name)(img, (10, 8))
        assert rbox == pbox
        np.testing.assert_array_equal(out.asnumpy(), ref.asnumpy())
    _seed(3)
    ref, rbox = rimg.random_size_crop(mx.nd.array(arr, dtype="uint8"),
                                      (9, 9), (0.2, 1.0), (0.7, 1.4))
    _seed(3)
    out, pbox = pimg.random_size_crop(img, (9, 9), (0.2, 1.0), (0.7, 1.4))
    assert rbox == pbox
    np.testing.assert_array_equal(out.asnumpy(), ref.asnumpy())
    assert pimg.scale_down((40, 30), (60, 50)) == \
        rimg.scale_down((40, 30), (60, 50))
    # a no-op stage hands back its input; an augmenter with only
    # __call__ works through apply_np
    assert pimg.HorizontalFlipAug(0.0)(img) is img

    class CallOnly(pimg.Augmenter):
        def __call__(self, src):
            return pmx.nd.array(src.asnumpy() * 2.0, ctx="cpu")

    np.testing.assert_array_equal(CallOnly().apply_np(np.ones((2, 2, 3))),
                                  np.full((2, 2, 3), 2.0))


def _image_folder(root, n=6, seed=1):
    rng = np.random.default_rng(seed)
    lst = []
    for i in range(n):
        name = f"img{i}.png"
        Image.fromarray(rng.integers(0, 255, (22 + i, 26, 3),
                                     dtype=np.uint8)).save(
            os.path.join(root, name))
        lst.append((float(i % 3), name))
    return lst


def test_image_iter_matches(tmp_path):
    lst = _image_folder(str(tmp_path))
    with open(tmp_path / "a.lst", "w") as f:
        for i, (lab, name) in enumerate(lst):
            f.write(f"{i}\t{lab}\t{name}\n")
    batches = []
    for mod in (rimg, pimg):
        _seed(6)
        it = mod.ImageIter(2, (3, 16, 16), path_root=str(tmp_path),
                           path_imglist=str(tmp_path / "a.lst"),
                           shuffle=True, aug_list=mod.CreateAugmenter(
                               (3, 16, 16), rand_crop=True, rand_mirror=True,
                               mean=True))
        batches.append([(b.data[0].asnumpy(), b.label[0].asnumpy())
                        for b in it])
    assert len(batches[1]) == 3
    for (rd, rl), (pd, pl) in zip(*batches):
        np.testing.assert_allclose(pd, rd, atol=1e-5)
        np.testing.assert_array_equal(pl, rl)
    assert pimg.ImageIter(2, (3, 16, 16), imglist=[[0.0, "x"]]) \
        .provide_label[0].name == "softmax_label"
    with pytest.raises(MXNetError):
        pimg.ImageIter(2, (3, 16, 16))


BOXES = np.array([[0, 0.1, 0.2, 0.5, 0.6], [1, 0.4, 0.3, 0.9, 0.95],
                  [2, 0.05, 0.5, 0.3, 0.9]], np.float32)

DET_AUGS = {
    "flip": lambda m: m.DetHorizontalFlipAug(0.7),
    "crop": lambda m: m.DetRandomCropAug(0.3, (0.75, 1.33), (0.3, 1.0)),
    "pad": lambda m: m.DetRandomPadAug((0.75, 1.33), (1.0, 2.5)),
    "select": lambda m: m.DetRandomSelectAug(
        [[m.DetHorizontalFlipAug(1.0)], [m.DetRandomPadAug()]], 0.2),
    "borrow": lambda m: m.DetBorrowAug(m.BrightnessJitterAug(0.2)),
    "create": lambda m: _Chain2(m.CreateDetAugmenter(
        (3, 20, 20), resize=24, rand_crop=0.8, rand_pad=0.8,
        rand_mirror=True, mean=True, std=True, brightness=0.1,
        contrast=0.1, saturation=0.1)),
}


class _Chain2:
    def __init__(self, augs):
        self.augs = augs

    def apply_np(self, arr, label):
        for a in self.augs:
            arr, label = a.apply_np(arr, label)
        return arr, label


@pytest.mark.parametrize("name", sorted(DET_AUGS))
@pytest.mark.parametrize("seed", [1, 5])
def test_detection_augmenters_match_with_their_boxes(name, seed):
    arr = _images(1, seed=seed)[0]
    (ra, rl), (pa, pl) = _both(DET_AUGS[name], arr, seed, det_label=BOXES)
    assert pa.shape == ra.shape and pa.dtype == ra.dtype
    np.testing.assert_allclose(pa, ra, atol=1e-5)
    np.testing.assert_array_equal(pl, rl)


def test_image_det_iter_matches(tmp_path):
    files = _image_folder(str(tmp_path), n=5, seed=2)
    imglist = [(BOXES[: 1 + i % 3], name) for i, (_, name) in
               enumerate(files)]
    batches = []
    for mod in (rimg, pimg):
        _seed(8)
        it = mod.ImageDetIter(2, (3, 18, 18), path_root=str(tmp_path),
                              imglist=imglist, shuffle=True,
                              aug_list=mod.CreateDetAugmenter(
                                  (3, 18, 18), rand_crop=0.5, rand_pad=0.5,
                                  rand_mirror=True))
        assert it.provide_label[0].shape == (2, 3, 5)
        batches.append([(b.data[0].asnumpy(), b.label[0].asnumpy())
                        for b in it])
    assert len(batches[1]) == 2
    for (rd, rl), (pd, pl) in zip(*batches):
        np.testing.assert_allclose(pd, rd, atol=1e-5)
        np.testing.assert_array_equal(pl, rl)
    with pytest.raises(MXNetError, match=r"\(N, 5\+\)"):
        pimg.ImageDetIter(1, (3, 8, 8), imglist=[(np.zeros(3), "x")])
