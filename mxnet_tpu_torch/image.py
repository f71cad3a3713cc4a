"""``mx.image``: host-side image loading and augmentation.

Counterpart of ``mxnet_tpu/image.py`` (:44-832), with its design: images
are HWC numpy arrays on the host, decoded with PIL; every augmenter works
on numpy through ``apply_np`` and the iterators run the whole chain in
numpy, so a pipeline takes one copy off an ``NDArray`` per image
(``_ensure_np``) and builds one CPU ``NDArray`` per batch.  The public
``__call__`` of each augmenter takes and returns ``NDArray``s.  Crops,
flips and jitters draw from Python's ``random`` (``LightingAug`` from
numpy's global stream), as the JAX package's do, so seeding both alike
gives both the same images.  ``CreateAugmenter``/``ImageIter`` and the
detection augmenters with ``CreateDetAugmenter``/``ImageDetIter`` (boxes
as ``[cls, x1, y1, x2, y2]`` rows normalised to [0, 1], padded with -1
rows to a fixed ``(batch, max_objs, 5)`` label) are MXNet's.
"""
from __future__ import annotations

import io as _io
import os
import math as _math
import random as _pyrandom
from typing import List, Optional, Sequence, Tuple

import numpy as _np

from .base import MXNetError
from .context import cpu
from .io import DataBatch, DataDesc, DataIter
from .ndarray import NDArray, array as nd_array

__all__ = ["imread", "imdecode", "imresize", "resize_short", "fixed_crop",
           "center_crop", "random_crop", "color_normalize", "HorizontalFlipAug",
           "ResizeAug", "ForceResizeAug", "CenterCropAug", "RandomCropAug",
           "CastAug", "ColorNormalizeAug", "BrightnessJitterAug",
           "ContrastJitterAug", "SaturationJitterAug", "CreateAugmenter",
           "Augmenter", "ImageIter",
           "scale_down", "random_size_crop", "RandomSizedCropAug",
           "HueJitterAug", "RandomOrderAug", "ColorJitterAug",
           "LightingAug", "RandomGrayAug"]


def _pil():
    try:
        from PIL import Image
        return Image
    except ImportError as e:
        raise MXNetError("image ops need PIL (not installed)") from e


def _ensure_np(src) -> _np.ndarray:
    """The pipeline's one ingestion point: an ``NDArray`` is read into
    numpy once at the head of the chain; every stage after it stays in
    numpy."""
    if isinstance(src, NDArray):
        return src.asnumpy()
    return _np.asarray(src)


def _imdecode_np(buf: bytes, to_rgb: bool = True, flag: int = 1
                 ) -> _np.ndarray:
    img = _np.asarray(_pil().open(_io.BytesIO(buf)).convert(
        "RGB" if flag else "L"))
    if img.ndim == 2:
        img = img[:, :, None]
    if not to_rgb and img.shape[2] == 3:
        img = img[:, :, ::-1]
    return img


def imdecode(buf: bytes, to_rgb: bool = True, flag: int = 1) -> NDArray:
    """Decode an encoded image buffer to an HWC NDArray
    (MXNet: mx.image.imdecode over cv2.imdecode)."""
    return nd_array(_imdecode_np(buf, to_rgb, flag), ctx=cpu())


def _imread_np(filename: str, to_rgb: bool = True, flag: int = 1
               ) -> _np.ndarray:
    with open(filename, "rb") as f:
        return _imdecode_np(f.read(), to_rgb=to_rgb, flag=flag)


def imread(filename: str, to_rgb: bool = True, flag: int = 1) -> NDArray:
    return nd_array(_imread_np(filename, to_rgb, flag), ctx=cpu())


def _imresize_np(arr: _np.ndarray, w: int, h: int,
                 interp: int = 1) -> _np.ndarray:
    Image = _pil()
    mode = arr.astype(_np.uint8) if arr.dtype != _np.uint8 else arr
    resample = {0: Image.NEAREST, 1: Image.BILINEAR, 2: Image.BICUBIC,
                3: Image.LANCZOS}.get(interp, Image.BILINEAR)
    out = _np.asarray(Image.fromarray(mode.squeeze() if mode.shape[-1] == 1
                                      else mode).resize((w, h), resample))
    if out.ndim == 2:
        out = out[:, :, None]
    return out.astype(arr.dtype)


def imresize(src, w: int, h: int, interp: int = 1) -> NDArray:
    return nd_array(_imresize_np(_ensure_np(src), w, h, interp),
                    ctx=cpu())


def _resize_short_np(arr: _np.ndarray, size: int,
                     interp: int = 1) -> _np.ndarray:
    h, w = arr.shape[:2]
    if h > w:
        nw, nh = size, int(h * size / w)
    else:
        nw, nh = int(w * size / h), size
    return _imresize_np(arr, nw, nh, interp)


def resize_short(src, size: int, interp: int = 1) -> NDArray:
    return nd_array(_resize_short_np(_ensure_np(src), size, interp),
                    ctx=cpu())


def _fixed_crop_np(arr: _np.ndarray, x0: int, y0: int, w: int, h: int,
                   size: Optional[Tuple[int, int]] = None,
                   interp: int = 1) -> _np.ndarray:
    out = arr[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        return _imresize_np(out, size[0], size[1], interp)
    return out


def fixed_crop(src, x0: int, y0: int, w: int, h: int,
               size: Optional[Tuple[int, int]] = None,
               interp: int = 1) -> NDArray:
    return nd_array(_fixed_crop_np(_ensure_np(src), x0, y0, w, h, size,
                                   interp), ctx=cpu())


def _center_crop_np(arr: _np.ndarray, size: Tuple[int, int],
                    interp: int = 1):
    h, w = arr.shape[:2]
    cw, ch = size
    x0 = max((w - cw) // 2, 0)
    y0 = max((h - ch) // 2, 0)
    out = _fixed_crop_np(arr, x0, y0, min(cw, w), min(ch, h), size, interp)
    return out, (x0, y0, cw, ch)


def center_crop(src, size: Tuple[int, int], interp: int = 1):
    out, coords = _center_crop_np(_ensure_np(src), size, interp)
    return nd_array(out, ctx=cpu()), coords


def _random_crop_np(arr: _np.ndarray, size: Tuple[int, int],
                    interp: int = 1):
    h, w = arr.shape[:2]
    cw, ch = size
    x0 = _pyrandom.randint(0, max(w - cw, 0))
    y0 = _pyrandom.randint(0, max(h - ch, 0))
    out = _fixed_crop_np(arr, x0, y0, min(cw, w), min(ch, h), size, interp)
    return out, (x0, y0, cw, ch)


def random_crop(src, size: Tuple[int, int], interp: int = 1):
    out, coords = _random_crop_np(_ensure_np(src), size, interp)
    return nd_array(out, ctx=cpu()), coords


def scale_down(src_size: Tuple[int, int], size: Tuple[int, int]):
    """Shrink `size` (w, h) to fit within `src_size` keeping aspect
    (MXNet mx.image.scale_down)."""
    w, h = size
    sw, sh = src_size
    if sh < h:
        w, h = float(w * sh) / h, sh
    if sw < w:
        w, h = sw, float(h * sw) / w
    return int(w), int(h)


def _random_size_crop_np(arr: _np.ndarray, size: Tuple[int, int], area,
                         ratio, interp: int = 1):
    h, w = arr.shape[:2]
    src_area = h * w
    if isinstance(area, (int, float)):
        area = (area, 1.0)
    for _ in range(10):
        target_area = _pyrandom.uniform(area[0], area[1]) * src_area
        log_ratio = (_math.log(ratio[0]), _math.log(ratio[1]))
        new_ratio = _math.exp(_pyrandom.uniform(*log_ratio))
        new_w = int(round(_math.sqrt(target_area * new_ratio)))
        new_h = int(round(_math.sqrt(target_area / new_ratio)))
        if new_w <= w and new_h <= h:
            x0 = _pyrandom.randint(0, w - new_w)
            y0 = _pyrandom.randint(0, h - new_h)
            out = _fixed_crop_np(arr, x0, y0, new_w, new_h, size, interp)
            return out, (x0, y0, new_w, new_h)
    return _center_crop_np(arr, size, interp)      # fallback


def random_size_crop(src, size: Tuple[int, int], area, ratio,
                     interp: int = 1, **kwargs):
    """Random area/aspect crop then resize to `size` (MXNet
    mx.image.random_size_crop — the inception-style crop)."""
    out, coords = _random_size_crop_np(_ensure_np(src), size, area,
                                       ratio, interp)
    return nd_array(out, ctx=cpu()), coords


def _color_normalize_np(arr: _np.ndarray, mean, std=None) -> _np.ndarray:
    arr = arr.astype(_np.float32) - _np.asarray(mean, dtype=_np.float32)
    if std is not None:
        arr = arr / _np.asarray(std, dtype=_np.float32)
    return arr


def color_normalize(src, mean, std=None) -> NDArray:
    return nd_array(_color_normalize_np(_ensure_np(src), mean, std),
                    ctx=cpu())


# ---------------------------------------------------------------------------
# augmenter classes (MXNet: mx.image.Augmenter family)
# ---------------------------------------------------------------------------

class Augmenter:
    """Base augmenter.  Subclasses implement ``apply_np`` (host numpy in
    and out, the path the iterators use); ``__call__`` keeps MXNet's
    NDArray-in/NDArray-out surface by wrapping it (a no-op stage hands
    back ``src`` itself).  A user augmenter that overrides only
    ``__call__`` still works: the base ``apply_np`` routes through it."""

    def apply_np(self, arr: _np.ndarray) -> _np.ndarray:
        if type(self).__call__ is Augmenter.__call__:
            raise NotImplementedError(
                f"{type(self).__name__} implements neither apply_np nor "
                f"__call__")
        # only __call__ overridden: go through the NDArray surface
        return _ensure_np(self(nd_array(arr, ctx=cpu())))

    def __call__(self, src: NDArray) -> NDArray:
        arr = _ensure_np(src)
        out = self.apply_np(arr)
        if out is arr and isinstance(src, NDArray):
            return src
        return nd_array(out, ctx=cpu())


class ResizeAug(Augmenter):
    def __init__(self, size: int, interp: int = 1):
        self.size, self.interp = size, interp

    def apply_np(self, arr):
        return _resize_short_np(arr, self.size, self.interp)


class ForceResizeAug(Augmenter):
    def __init__(self, size: Tuple[int, int], interp: int = 1):
        self.size, self.interp = size, interp

    def apply_np(self, arr):
        return _imresize_np(arr, self.size[0], self.size[1], self.interp)


class CenterCropAug(Augmenter):
    def __init__(self, size: Tuple[int, int], interp: int = 1):
        self.size, self.interp = size, interp

    def apply_np(self, arr):
        return _center_crop_np(arr, self.size, self.interp)[0]


class RandomCropAug(Augmenter):
    def __init__(self, size: Tuple[int, int], interp: int = 1):
        self.size, self.interp = size, interp

    def apply_np(self, arr):
        return _random_crop_np(arr, self.size, self.interp)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p: float = 0.5):
        self.p = p

    def apply_np(self, arr):
        if _pyrandom.random() < self.p:
            return arr[:, ::-1].copy()
        return arr


class CastAug(Augmenter):
    def __init__(self, dtype="float32"):
        self.dtype = dtype

    def apply_np(self, arr):
        return arr.astype(self.dtype)


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        self.mean, self.std = mean, std

    def apply_np(self, arr):
        return _color_normalize_np(arr, self.mean, self.std)


class _JitterAug(Augmenter):
    def __init__(self, jitter: float):
        self.jitter = jitter

    def _coef(self) -> float:
        return 1.0 + _pyrandom.uniform(-self.jitter, self.jitter)


class BrightnessJitterAug(_JitterAug):
    def apply_np(self, arr):
        return arr.astype(_np.float32) * self._coef()


class ContrastJitterAug(_JitterAug):
    def apply_np(self, arr):
        arr = arr.astype(_np.float32)
        mean = arr.mean()
        return (arr - mean) * self._coef() + mean


class SaturationJitterAug(_JitterAug):
    def apply_np(self, arr):
        arr = arr.astype(_np.float32)
        gray = arr.mean(axis=2, keepdims=True)
        c = self._coef()
        return arr * c + gray * (1.0 - c)


class RandomSizedCropAug(Augmenter):
    def __init__(self, size, area, ratio, interp: int = 1):
        self.size, self.area, self.ratio, self.interp = \
            size, area, ratio, interp

    def apply_np(self, arr):
        return _random_size_crop_np(arr, self.size, self.area, self.ratio,
                                    self.interp)[0]


class HueJitterAug(Augmenter):
    """Hue rotation in YIQ space (MXNet HueJitterAug's tyiq/ityiq
    matrices)."""

    _TYIQ = _np.array([[0.299, 0.587, 0.114],
                       [0.596, -0.274, -0.321],
                       [0.211, -0.523, 0.311]], _np.float32)
    _ITYIQ = _np.array([[1.0, 0.956, 0.621],
                        [1.0, -0.272, -0.647],
                        [1.0, -1.107, 1.705]], _np.float32)

    def __init__(self, hue: float):
        self.hue = hue

    def apply_np(self, arr):
        alpha = _pyrandom.uniform(-self.hue, self.hue)
        u = _math.cos(alpha * _math.pi)
        w = _math.sin(alpha * _math.pi)
        bt = _np.array([[1.0, 0.0, 0.0], [0.0, u, -w], [0.0, w, u]],
                       _np.float32)
        t = self._ITYIQ @ bt @ self._TYIQ
        return arr.astype(_np.float32) @ t.T


class RandomOrderAug(Augmenter):
    """Apply child augmenters in random order (MXNet RandomOrderAug)."""

    def __init__(self, ts):
        self.ts = list(ts)

    def apply_np(self, arr):
        order = list(self.ts)
        _pyrandom.shuffle(order)
        for t in order:
            arr = t.apply_np(arr)
        return arr


class ColorJitterAug(RandomOrderAug):
    """Brightness/contrast/saturation jitter in random order (MXNet
    ColorJitterAug)."""

    def __init__(self, brightness: float, contrast: float,
                 saturation: float):
        ts = []
        if brightness > 0:
            ts.append(BrightnessJitterAug(brightness))
        if contrast > 0:
            ts.append(ContrastJitterAug(contrast))
        if saturation > 0:
            ts.append(SaturationJitterAug(saturation))
        super().__init__(ts)


class LightingAug(Augmenter):
    """PCA-noise lighting (MXNet LightingAug / AlexNet-style)."""

    def __init__(self, alphastd, eigval, eigvec):
        self.alphastd = alphastd
        self.eigval = _np.asarray(eigval, _np.float32)
        self.eigvec = _np.asarray(eigvec, _np.float32)

    def apply_np(self, arr):
        alpha = _np.random.normal(0, self.alphastd, size=(3,))
        rgb = (self.eigvec * alpha) @ self.eigval
        return arr.astype(_np.float32) + rgb


class RandomGrayAug(Augmenter):
    """Convert to 3-channel gray with probability p (MXNet
    RandomGrayAug)."""

    _MAT = _np.array([[0.21, 0.21, 0.21],
                      [0.72, 0.72, 0.72],
                      [0.07, 0.07, 0.07]], _np.float32)

    def __init__(self, p: float = 0.5):
        self.p = p

    def apply_np(self, arr):
        if _pyrandom.random() < self.p:
            return arr.astype(_np.float32) @ self._MAT
        return arr


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None,
                    brightness=0, contrast=0, saturation=0, hue=0,
                    pca_noise=0, rand_gray=0, inter_method=1,
                    **kwargs) -> List[Augmenter]:
    """Standard augmenter pipeline factory (MXNet: CreateAugmenter)."""
    auglist: List[Augmenter] = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop = (data_shape[2], data_shape[1])
    if rand_resize:
        # inception-style random area/aspect crop (MXNet: rand_resize
        # implies rand_crop)
        auglist.append(RandomSizedCropAug(crop, (0.08, 1.0),
                                          (3.0 / 4.0, 4.0 / 3.0),
                                          inter_method))
    elif rand_crop:
        auglist.append(RandomCropAug(crop, inter_method))
    else:
        auglist.append(CenterCropAug(crop, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation))
    if hue:
        auglist.append(HueJitterAug(hue))
    if pca_noise > 0:
        eigval = _np.array([55.46, 4.794, 1.148])
        eigvec = _np.array([[-0.5675, 0.7192, 0.4009],
                            [-0.5808, -0.0045, -0.8140],
                            [-0.5836, -0.6948, 0.4203]])
        auglist.append(LightingAug(pca_noise, eigval, eigvec))
    if rand_gray > 0:
        auglist.append(RandomGrayAug(rand_gray))
    if mean is True:
        mean = _np.array([123.68, 116.28, 103.53])
    if std is True:
        std = _np.array([58.395, 57.12, 57.375])
    if mean is not None:
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


class ImageIter(DataIter):
    """Python-side image iterator over (label, path) lists or .lst files
    (MXNet: mx.image.ImageIter)."""

    def __init__(self, batch_size: int, data_shape: Sequence[int],
                 path_root: str = "", imglist=None, path_imglist: str = "",
                 shuffle: bool = False, aug_list=None,
                 label_width: int = 1, **kwargs):
        super().__init__(batch_size)
        self.data_shape = tuple(data_shape)
        self.path_root = path_root
        self.label_width = label_width
        if imglist is None and path_imglist:
            imglist = []
            with open(path_imglist) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    imglist.append([float(x) for x in
                                    parts[1:1 + label_width]] + [parts[-1]])
        if not imglist:
            raise MXNetError("ImageIter needs imglist or path_imglist")
        self.imglist = list(imglist)
        self.shuffle = shuffle
        self.aug_list = aug_list if aug_list is not None else \
            CreateAugmenter(data_shape)
        self.cur = 0
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        shape = (self.batch_size,) if self.label_width == 1 else \
            (self.batch_size, self.label_width)
        return [DataDesc("softmax_label", shape)]

    def reset(self):
        if self.shuffle:
            _pyrandom.shuffle(self.imglist)
        self.cur = 0

    def next(self) -> DataBatch:
        if self.cur + self.batch_size > len(self.imglist):
            raise StopIteration
        datas, labels = [], []
        for entry in self.imglist[self.cur:self.cur + self.batch_size]:
            *label, path = entry
            # the whole chain runs in host numpy: zero device round trips
            # until the one batched upload below
            arr = _imread_np(os.path.join(self.path_root, path))
            for aug in self.aug_list:
                arr = aug.apply_np(arr)
            datas.append(arr.transpose(2, 0, 1))
            labels.append(label if self.label_width > 1 else label[0])
        self.cur += self.batch_size
        return DataBatch(
            [nd_array(_np.stack(datas).astype(_np.float32), ctx=cpu())],
            [nd_array(_np.asarray(labels, dtype=_np.float32), ctx=cpu())],
            provide_data=self.provide_data,
            provide_label=self.provide_label)


# ---------------------------------------------------------------------------
# Detection augmentation (MXNet: python/mxnet/image/detection.py)
# ---------------------------------------------------------------------------
# Labels ride with the image through every augmenter as an (N, 5+) float
# array [cls, x1, y1, x2, y2, ...] with corner coords normalized to [0,1];
# geometric augmenters transform the boxes, photometric ones borrow the
# plain image augmenters unchanged.

class DetAugmenter:
    """Base detection augmenter: ``(src, label) -> (src, label)``.
    Subclasses implement ``apply_np`` (numpy image + label in/out);
    ``__call__`` keeps the NDArray surface, as with :class:`Augmenter`
    (including the ``__call__``-only bridge)."""

    def apply_np(self, arr, label):
        if type(self).__call__ is DetAugmenter.__call__:
            raise NotImplementedError(
                f"{type(self).__name__} implements neither apply_np nor "
                f"__call__")
        out, label = self(nd_array(arr, ctx=cpu()), label)
        return _ensure_np(out), label

    def __call__(self, src, label):
        arr = _ensure_np(src)
        out, label = self.apply_np(arr, label)
        if out is arr and isinstance(src, NDArray):
            return src, label
        return nd_array(out, ctx=cpu()), label


class DetBorrowAug(DetAugmenter):
    """Wrap a geometry-preserving image Augmenter (MXNet
    DetBorrowAug)."""

    def __init__(self, augmenter: Augmenter):
        self.augmenter = augmenter

    def apply_np(self, arr, label):
        return self.augmenter.apply_np(arr), label


class DetHorizontalFlipAug(DetAugmenter):
    """Mirror image and boxes with probability p."""

    def __init__(self, p: float = 0.5):
        self.p = p

    def apply_np(self, arr, label):
        if _pyrandom.random() < self.p:
            arr = arr[:, ::-1].copy()
            label = label.copy()
            x1 = label[:, 1].copy()
            label[:, 1] = 1.0 - label[:, 3]
            label[:, 3] = 1.0 - x1
        return arr, label


class DetRandomCropAug(DetAugmenter):
    """IoU-constrained random crop (MXNet DetRandomCropAug): sample a
    crop whose min-object coverage clears the threshold; keep boxes whose
    centers fall inside, clip and renormalize them."""

    def __init__(self, min_object_covered=0.1,
                 aspect_ratio_range=(0.75, 1.33), area_range=(0.05, 1.0),
                 max_attempts=50):
        self.min_object_covered = min_object_covered
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = max_attempts

    def _coverage(self, boxes, crop):
        cx1, cy1, cx2, cy2 = crop
        ix1 = _np.maximum(boxes[:, 1], cx1)
        iy1 = _np.maximum(boxes[:, 2], cy1)
        ix2 = _np.minimum(boxes[:, 3], cx2)
        iy2 = _np.minimum(boxes[:, 4], cy2)
        inter = _np.maximum(ix2 - ix1, 0) * _np.maximum(iy2 - iy1, 0)
        area = (boxes[:, 3] - boxes[:, 1]) * (boxes[:, 4] - boxes[:, 2])
        return inter / _np.maximum(area, 1e-12)

    def apply_np(self, arr, label):
        h, w = arr.shape[0], arr.shape[1]
        for _ in range(self.max_attempts):
            area_f = _pyrandom.uniform(*self.area_range)
            ar = _pyrandom.uniform(*self.aspect_ratio_range)
            cw = min(1.0, _np.sqrt(area_f * ar))
            ch = min(1.0, area_f / max(cw, 1e-12))
            cx = _pyrandom.uniform(0, 1 - cw)
            cy = _pyrandom.uniform(0, 1 - ch)
            crop = (cx, cy, cx + cw, cy + ch)
            if label.shape[0]:
                cov = self._coverage(label, crop)
                if cov.max(initial=0.0) < self.min_object_covered:
                    continue
                centers_x = (label[:, 1] + label[:, 3]) / 2
                centers_y = (label[:, 2] + label[:, 4]) / 2
                keep = ((centers_x >= cx) & (centers_x <= cx + cw) &
                        (centers_y >= cy) & (centers_y <= cy + ch))
                if not keep.any():
                    continue
            else:
                keep = _np.zeros((0,), bool)
            x0, y0 = int(cx * w), int(cy * h)
            pw, ph = max(1, int(cw * w)), max(1, int(ch * h))
            img = _fixed_crop_np(arr, x0, y0, pw, ph)
            new = label[keep].copy()
            if new.shape[0]:
                new[:, 1] = _np.clip((new[:, 1] - cx) / cw, 0, 1)
                new[:, 3] = _np.clip((new[:, 3] - cx) / cw, 0, 1)
                new[:, 2] = _np.clip((new[:, 2] - cy) / ch, 0, 1)
                new[:, 4] = _np.clip((new[:, 4] - cy) / ch, 0, 1)
            return img, new
        return arr, label


class DetRandomPadAug(DetAugmenter):
    """Expand the canvas and place the image randomly (MXNet
    DetRandomPadAug); boxes shrink into the new frame."""

    def __init__(self, aspect_ratio_range=(0.75, 1.33),
                 area_range=(1.0, 3.0), max_attempts=50,
                 pad_val=(127, 127, 127)):
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = max_attempts
        self.pad_val = pad_val

    def apply_np(self, arr, label):
        h, w, c = arr.shape
        # retry like DetRandomCropAug: keep sampling until the draw
        # actually expands the canvas
        scale = 1.0
        for _ in range(self.max_attempts):
            scale = _pyrandom.uniform(*self.area_range)
            if scale > 1.0:
                break
        if scale <= 1.0:
            return arr, label
        ar = _pyrandom.uniform(*self.aspect_ratio_range)
        nw = int(w * _np.sqrt(scale * ar))
        nh = int(h * scale / max(_np.sqrt(scale * ar), 1e-12))
        nw, nh = max(nw, w), max(nh, h)
        x0 = _pyrandom.randint(0, nw - w)
        y0 = _pyrandom.randint(0, nh - h)
        canvas = _np.empty((nh, nw, c), arr.dtype)
        canvas[:] = _np.asarray(self.pad_val)[:c]
        canvas[y0:y0 + h, x0:x0 + w] = arr
        new = label.copy()
        if new.shape[0]:
            new[:, 1] = (new[:, 1] * w + x0) / nw
            new[:, 3] = (new[:, 3] * w + x0) / nw
            new[:, 2] = (new[:, 2] * h + y0) / nh
            new[:, 4] = (new[:, 4] * h + y0) / nh
        return canvas, new


class DetRandomSelectAug(DetAugmenter):
    """Randomly pick one of several augmenter lists (MXNet
    DetRandomSelectAug); skip_prob leaves the sample unchanged."""

    def __init__(self, aug_list, skip_prob: float = 0.0):
        self.aug_list = aug_list
        self.skip_prob = skip_prob

    def apply_np(self, arr, label):
        if _pyrandom.random() < self.skip_prob:
            return arr, label
        for aug in _pyrandom.choice(self.aug_list):
            arr, label = aug.apply_np(arr, label)
        return arr, label


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0.0, rand_pad=0.0,
                       rand_mirror=False, mean=None, std=None, brightness=0,
                       contrast=0, saturation=0, pad_val=(127, 127, 127),
                       min_object_covered=0.1,
                       aspect_ratio_range=(0.75, 1.33),
                       area_range=(0.05, 3.0), max_attempts=50,
                       inter_method=1, **kwargs) -> List[DetAugmenter]:
    """Detection pipeline factory (MXNet CreateDetAugmenter)."""
    auglist: List[DetAugmenter] = []
    if resize > 0:
        auglist.append(DetBorrowAug(ResizeAug(resize, inter_method)))
    if rand_crop > 0:
        crop = DetRandomCropAug(min_object_covered, aspect_ratio_range,
                                (area_range[0], min(1.0, area_range[1])),
                                max_attempts)
        auglist.append(DetRandomSelectAug([[crop]], 1 - rand_crop))
    if rand_pad > 0:
        pad = DetRandomPadAug(aspect_ratio_range,
                              (1.0, max(1.0, area_range[1])), max_attempts,
                              pad_val)
        auglist.append(DetRandomSelectAug([[pad]], 1 - rand_pad))
    if rand_mirror:
        auglist.append(DetHorizontalFlipAug(0.5))
    # final shape: force resize to the network input
    auglist.append(DetBorrowAug(
        ForceResizeAug((data_shape[2], data_shape[1]), inter_method)))
    auglist.append(DetBorrowAug(CastAug()))
    if brightness:
        auglist.append(DetBorrowAug(BrightnessJitterAug(brightness)))
    if contrast:
        auglist.append(DetBorrowAug(ContrastJitterAug(contrast)))
    if saturation:
        auglist.append(DetBorrowAug(SaturationJitterAug(saturation)))
    if mean is True:
        mean = _np.array([123.68, 116.28, 103.53])
    if std is True:
        std = _np.array([58.395, 57.12, 57.375])
    if mean is not None:
        auglist.append(DetBorrowAug(ColorNormalizeAug(mean, std)))
    return auglist


class ImageDetIter(DataIter):
    """Detection iterator (MXNet mx.image.ImageDetIter): images plus
    variable-count box labels, padded to a fixed (batch, max_objs, 5)
    label tensor with -1 rows, the static shape the SSD target ops
    need."""

    def __init__(self, batch_size: int, data_shape: Sequence[int],
                 path_root: str = "", imglist=None, shuffle: bool = False,
                 aug_list=None, data_name: str = "data",
                 label_name: str = "label", **kwargs):
        super().__init__(batch_size)
        self.data_shape = tuple(data_shape)
        self.path_root = path_root
        self.data_name = data_name
        self.label_name = label_name
        if not imglist:
            raise MXNetError("ImageDetIter needs imglist: entries of "
                             "[label_array (N,5+), path]")
        self.imglist = []
        for lab, path in imglist:
            lab = _np.asarray(lab, _np.float32)
            if lab.ndim == 1:
                lab = lab.reshape(1, -1)
            if lab.ndim != 2 or lab.shape[1] < 5:
                raise MXNetError(
                    f"detection label for {path!r} must be (N, 5+) "
                    f"[cls, x1, y1, x2, y2, ...], got {lab.shape}")
            # extra columns beyond 5 (difficult flags etc.) are dropped;
            # never re-chunk the buffer
            self.imglist.append((lab[:, :5].copy(), path))
        self.max_objs = max(lab.shape[0] for lab, _ in self.imglist)
        self.shuffle = shuffle
        self.aug_list = aug_list if aug_list is not None else \
            CreateDetAugmenter(data_shape)
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(self.data_name,
                         (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        return [DataDesc(self.label_name,
                         (self.batch_size, self.max_objs, 5))]

    def reset(self):
        if self.shuffle:
            _pyrandom.shuffle(self.imglist)
        self.cur = 0

    def next(self) -> DataBatch:
        if self.cur + self.batch_size > len(self.imglist):
            raise StopIteration
        datas, labels = [], []
        for lab, path in self.imglist[self.cur:self.cur + self.batch_size]:
            # host-numpy end to end, like ImageIter.next
            arr = _imread_np(os.path.join(self.path_root, path))
            label = lab.copy()
            for aug in self.aug_list:
                arr, label = aug.apply_np(arr, label)
            datas.append(arr.transpose(2, 0, 1))
            pad = _np.full((self.max_objs, 5), -1.0, _np.float32)
            n = min(label.shape[0], self.max_objs)
            if n:
                pad[:n] = label[:n, :5]
            labels.append(pad)
        self.cur += self.batch_size
        return DataBatch(
            [nd_array(_np.stack(datas).astype(_np.float32), ctx=cpu())],
            [nd_array(_np.stack(labels), ctx=cpu())],
            provide_data=self.provide_data,
            provide_label=self.provide_label)


__all__ += ["DetAugmenter", "DetBorrowAug", "DetHorizontalFlipAug",
            "DetRandomCropAug", "DetRandomPadAug", "DetRandomSelectAug",
            "CreateDetAugmenter", "ImageDetIter"]
