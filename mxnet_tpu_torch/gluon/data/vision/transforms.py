"""Image transforms (counterpart of
``mxnet_tpu/gluon/data/vision/transforms.py``, MXNet's
python/mxnet/gluon/data/vision/transforms.py).

Transforms take HWC uint8/float ``NDArray``s (or numpy) on the host and
give CPU ``NDArray``s, with the JAX package's numpy arithmetic bit for
bit: its nearest-neighbour ``_resize_np`` and its ``np.random`` draws.
Only ``ToTensor`` moves to CHW float.
"""
from __future__ import annotations

import numpy as _np

from ....base import MXNetError
from ....context import cpu
from ....ndarray import NDArray, array as _nd_array

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize", "CropResize",
           "CenterCrop", "RandomResizedCrop", "RandomFlipLeftRight",
           "RandomFlipTopBottom", "RandomBrightness", "RandomContrast",
           "RandomSaturation", "RandomHue", "RandomLighting", "RandomColorJitter"]


def nd_array(a):
    return _nd_array(a, ctx=cpu())


def _to_np(x):
    return x.asnumpy() if isinstance(x, NDArray) else _np.asarray(x)


class Compose:
    def __init__(self, transforms):
        self._transforms = transforms

    def __call__(self, x, *args):
        for t in self._transforms:
            x = t(x)
        return (x,) + args if args else x


class Cast:
    def __init__(self, dtype="float32"):
        self._dtype = dtype

    def __call__(self, x):
        return x.astype(self._dtype) if isinstance(x, NDArray) else \
            nd_array(_to_np(x).astype(self._dtype))


class ToTensor:
    """HWC uint8 [0,255] → CHW float32 [0,1] (MXNet semantics)."""

    def __call__(self, x):
        a = _to_np(x).astype(_np.float32) / 255.0
        if a.ndim == 3:
            a = a.transpose(2, 0, 1)
        elif a.ndim == 4:
            a = a.transpose(0, 3, 1, 2)
        return nd_array(a)


class Normalize:
    def __init__(self, mean=0.0, std=1.0):
        self._mean = _np.asarray(mean, _np.float32)
        self._std = _np.asarray(std, _np.float32)

    def __call__(self, x):
        a = _to_np(x)
        mean = self._mean.reshape(-1, 1, 1) if self._mean.ndim else self._mean
        std = self._std.reshape(-1, 1, 1) if self._std.ndim else self._std
        return nd_array((a - mean) / std)


def _resize_np(a, size):
    """Nearest-neighbor host-side resize (no OpenCV dependency)."""
    h, w = a.shape[:2]
    if isinstance(size, int):
        ow, oh = size, size
    else:
        ow, oh = size
    ys = (_np.arange(oh) * (h / oh)).astype(_np.int64).clip(0, h - 1)
    xs = (_np.arange(ow) * (w / ow)).astype(_np.int64).clip(0, w - 1)
    return a[ys][:, xs]


class Resize:
    def __init__(self, size, keep_ratio=False, interpolation=1):
        self._size = size

    def __call__(self, x):
        return nd_array(_resize_np(_to_np(x), self._size))


class CenterCrop:
    def __init__(self, size, interpolation=1):
        self._size = (size, size) if isinstance(size, int) else size

    def __call__(self, x):
        a = _to_np(x)
        h, w = a.shape[:2]
        cw, ch = self._size
        y0 = max(0, (h - ch) // 2)
        x0 = max(0, (w - cw) // 2)
        return nd_array(a[y0:y0 + ch, x0:x0 + cw])


class CropResize:
    """Crop a fixed box then resize (MXNet transforms.CropResize:
    x0/y0 upper-left corner, width/height box, optional output size)."""

    def __init__(self, x0, y0, width, height, size=None, interpolation=1):
        self._box = (int(x0), int(y0), int(width), int(height))
        self._size = None if size is None else (
            (size, size) if isinstance(size, int) else tuple(size))

    def __call__(self, x):
        a = _to_np(x)
        x0, y0, w, h = self._box
        H, W = a.shape[:2]
        if x0 < 0 or y0 < 0 or x0 + w > W or y0 + h > H:
            raise MXNetError(
                f"CropResize box (x0={x0}, y0={y0}, w={w}, h={h}) exceeds "
                f"image size (w={W}, h={H})")
        crop = a[y0:y0 + h, x0:x0 + w]
        if self._size is not None:
            crop = _resize_np(crop, self._size)
        return nd_array(crop)


class RandomResizedCrop:
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation=1):
        self._size = size
        self._scale = scale
        self._ratio = ratio

    def __call__(self, x):
        a = _to_np(x)
        h, w = a.shape[:2]
        area = h * w
        for _ in range(10):
            target = area * _np.random.uniform(*self._scale)
            aspect = _np.random.uniform(*self._ratio)
            cw = int(round(_np.sqrt(target * aspect)))
            ch = int(round(_np.sqrt(target / aspect)))
            if cw <= w and ch <= h:
                x0 = _np.random.randint(0, w - cw + 1)
                y0 = _np.random.randint(0, h - ch + 1)
                crop = a[y0:y0 + ch, x0:x0 + cw]
                return nd_array(_resize_np(crop, self._size))
        return nd_array(_resize_np(a, self._size))


class RandomFlipLeftRight:
    def __call__(self, x):
        a = _to_np(x)
        if _np.random.rand() < 0.5:
            a = a[:, ::-1].copy()
        return nd_array(a)


class RandomFlipTopBottom:
    def __call__(self, x):
        a = _to_np(x)
        if _np.random.rand() < 0.5:
            a = a[::-1].copy()
        return nd_array(a)


class _RandomJitter:
    def __init__(self, amount):
        self._amount = amount

    def _factor(self):
        return 1.0 + _np.random.uniform(-self._amount, self._amount)


class RandomBrightness(_RandomJitter):
    def __call__(self, x):
        a = _to_np(x).astype(_np.float32)
        return nd_array(_np.clip(a * self._factor(), 0, 255))


class RandomContrast(_RandomJitter):
    def __call__(self, x):
        a = _to_np(x).astype(_np.float32)
        mean = a.mean()
        return nd_array(_np.clip((a - mean) * self._factor() + mean, 0, 255))


class RandomSaturation(_RandomJitter):
    def __call__(self, x):
        from ....ndarray.ops_image import LUMA
        a = _to_np(x).astype(_np.float32)
        gray = (a * LUMA).sum(axis=-1, keepdims=True)
        f = self._factor()
        return nd_array(_np.clip(a * f + gray * (1 - f), 0, 255))


class RandomHue(_RandomJitter):
    """Hue jitter (MXNet transforms.RandomHue): rotate RGB around the
    gray axis by a random angle scaled from the jitter amount."""

    def __call__(self, x):
        # one shared YIQ rotation (ops_image.py) — op and transform
        # cannot drift, and f=0 is an exact identity
        from ....ndarray.ops_image import hue_rotation_matrix
        a = _to_np(x).astype(_np.float32)
        f = self._factor() - 1.0            # in [-amount, amount]
        m = hue_rotation_matrix(f)
        return nd_array(_np.clip(a @ m.T, 0, 255))


class RandomLighting:
    def __init__(self, alpha):
        self._alpha = alpha

    def __call__(self, x):
        from ....ndarray.ops_image import (LIGHTING_EIGVAL,
                                           LIGHTING_EIGVEC)
        a = _to_np(x).astype(_np.float32)
        alpha = _np.random.normal(0, self._alpha, 3)
        rgb = LIGHTING_EIGVEC @ (alpha * LIGHTING_EIGVAL)
        return nd_array(_np.clip(a + rgb, 0, 255))


class RandomColorJitter:
    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        self._ts = []
        if brightness:
            self._ts.append(RandomBrightness(brightness))
        if contrast:
            self._ts.append(RandomContrast(contrast))
        if saturation:
            self._ts.append(RandomSaturation(saturation))
        if hue:
            self._ts.append(RandomHue(hue))

    def __call__(self, x):
        for t in self._ts:
            x = t(x)
        return x
