"""The ``_image_*`` operators behind ``mx.nd.image.*``.

Counterpart of ``mxnet_tpu/ndarray/ops_image.py`` (:59-212): the 13 ops
``to_tensor``, ``normalize``, ``flip_left_right``, ``flip_top_bottom``
and their ``random_`` forms, ``resize``, ``crop``, ``adjust_lighting``
and ``random_brightness``/``contrast``/``saturation``/``hue``, on HWC
images or NHWC batches (``to_tensor`` gives CHW/NCHW, ``normalize``
takes it).  ``resize`` is the JAX package's ``jax.image.resize``:
``interp=0`` nearest (index ``floor((i + 0.5) * in / out)``), else the
triangle filter with half-pixel centres, widened by the scale when it
downsamples (antialiasing), one weight matrix per axis.

The random ops draw their factor on the host from the CPU generator of
``mx.random`` (``_host_uniform``), so ``mx.random.seed`` reproduces them.
The JAX package draws from its threefry key stream, which the port does
not reproduce (as ``nd.random`` does not).
"""
from __future__ import annotations

import numpy as _np
import torch

from .. import random as _random
from ..base import MXNetError
from ..context import cpu
from .register import register_op

#: ITU-R BT.601 luma weights (MXNet's RGB2GRAY convention)
LUMA = _np.array([0.299, 0.587, 0.114], _np.float32)

#: AlexNet PCA lighting basis over ImageNet RGB
LIGHTING_EIGVAL = _np.array([55.46, 4.794, 1.148], _np.float32)
LIGHTING_EIGVEC = _np.array([[-0.5675, 0.7192, 0.4009],
                             [-0.5808, -0.0045, -0.8140],
                             [-0.5836, -0.6948, 0.4203]], _np.float32)

_T_YIQ = _np.array([[0.299, 0.587, 0.114],
                    [0.596, -0.274, -0.321],
                    [0.211, -0.523, 0.311]], _np.float64)


def hue_rotation_matrix(f: float) -> _np.ndarray:
    """RGB->RGB matrix rotating hue by f (in half-turns) in YIQ space,
    through the exact inverse of the YIQ matrix (f=0 is the identity)."""
    u, w = _np.cos(f * _np.pi), _np.sin(f * _np.pi)
    rot = _np.array([[1.0, 0.0, 0.0],
                     [0.0, u, -w],
                     [0.0, w, u]], _np.float64)
    return (_np.linalg.inv(_T_YIQ) @ rot @ _T_YIQ).astype(_np.float32)


def _host_uniform(lo: float, hi: float) -> float:
    """One draw from U(lo, hi) on the CPU generator of ``mx.random``."""
    t = torch.empty((), dtype=torch.float64)
    return float(t.uniform_(float(lo), float(hi),
                            generator=_random.generator(cpu())))


def _is_batch(x):
    return x.ndim == 4


def _hw(x):
    return (x.shape[1], x.shape[2]) if _is_batch(x) else \
        (x.shape[0], x.shape[1])


def _triangle_weights(n_in: int, n_out: int) -> _np.ndarray:
    """(n_in, n_out) weights of ``jax.image.resize``'s linear method
    (``compute_weight_mat``: antialiased triangle kernel, normalised
    columns, samples outside the input zeroed)."""
    inv_scale = _np.float32(1.0) / _np.float32(n_out / n_in)
    kernel_scale = max(inv_scale, _np.float32(1.0))
    sample = (_np.arange(n_out, dtype=_np.float32) + _np.float32(0.5)) * \
        inv_scale - _np.float32(0.5)
    x = _np.abs(sample[None, :] - _np.arange(n_in, dtype=_np.float32)[
        :, None]) / kernel_scale
    w = _np.maximum(0.0, 1.0 - _np.abs(x)).astype(_np.float32)
    total = w.sum(axis=0, keepdims=True)
    w = _np.where(_np.abs(total) > 1000.0 * _np.finfo(_np.float32).eps,
                  w / _np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return _np.where(inside[None, :], w, 0.0).astype(_np.float32)


def _nearest_index(n_in: int, n_out: int) -> _np.ndarray:
    off = (_np.arange(n_out, dtype=_np.float32) + 0.5) * \
        _np.float32(n_in) / _np.float32(n_out)
    return _np.floor(off.astype(_np.float32)).astype(_np.int64)


def to_tensor_maker():
    def fn(x):
        y = x.to(torch.float32) / 255.0
        return y.permute(0, 3, 1, 2) if _is_batch(x) else y.permute(2, 0, 1)
    return fn


def normalize_maker(mean=(0.0,), std=(1.0,)):
    m = torch.as_tensor(_np.asarray(mean, _np.float32))
    s = torch.as_tensor(_np.asarray(std, _np.float32))

    def fn(x):
        shape = (1, -1, 1, 1) if _is_batch(x) else (-1, 1, 1)
        return (x - m.to(x.device).reshape(shape)) / \
            s.to(x.device).reshape(shape)
    return fn


def flip_lr_maker():
    return lambda x: torch.flip(x, dims=(-2,))


def flip_tb_maker():
    return lambda x: torch.flip(x, dims=(-3,))


def random_flip_lr_maker():
    def fn(x):
        return torch.flip(x, dims=(-2,)) \
            if _host_uniform(0.0, 1.0) < 0.5 else x
    return fn


def random_flip_tb_maker():
    def fn(x):
        return torch.flip(x, dims=(-3,)) \
            if _host_uniform(0.0, 1.0) < 0.5 else x
    return fn


def resize_maker(size=0, keep_ratio=False, interp=1):
    def fn(x):
        hh, ww = _hw(x)
        if isinstance(size, (tuple, list)):
            w, h = int(size[0]), int(size[1])
        elif keep_ratio:
            # MXNet's resize-inl.h: a scalar size with keep_ratio scales
            # the short edge to size
            scale = int(size) / min(ww, hh)
            w, h = int(round(ww * scale)), int(round(hh * scale))
        else:
            w = h = int(size)
        ax = 1 if _is_batch(x) else 0
        if interp == 0:
            out = x
            if h != hh:
                out = out.index_select(ax, torch.as_tensor(
                    _nearest_index(hh, h), device=x.device))
            if w != ww:
                out = out.index_select(ax + 1, torch.as_tensor(
                    _nearest_index(ww, w), device=x.device))
            return out
        out = x.to(torch.float32)
        if h != hh:
            wy = torch.as_tensor(_triangle_weights(hh, h), device=x.device)
            out = torch.movedim(torch.tensordot(
                out, wy, dims=([ax], [0])), -1, ax)
        if w != ww:
            wx = torch.as_tensor(_triangle_weights(ww, w), device=x.device)
            out = torch.movedim(torch.tensordot(
                out, wx, dims=([ax + 1], [0])), -1, ax + 1)
        return out.to(x.dtype) if x.dtype != torch.float32 else out
    return fn


def crop_maker(x=0, y=0, width=0, height=0):
    def fn(data):
        hh, ww = _hw(data)
        if x < 0 or y < 0 or width <= 0 or height <= 0 \
                or x + width > ww or y + height > hh:
            raise MXNetError(
                f"crop window ({x},{y},{width},{height}) outside "
                f"image ({hh}x{ww})")
        if _is_batch(data):
            return data[:, y:y + height, x:x + width, :]
        return data[y:y + height, x:x + width, :]
    return fn


def adjust_lighting_maker(alpha=()):
    a = _np.asarray(alpha, _np.float32)
    delta = torch.as_tensor(
        (LIGHTING_EIGVEC * a * LIGHTING_EIGVAL).sum(axis=1))

    def fn(x):
        if not x.is_floating_point():
            raise MXNetError(
                "adjust_lighting requires float input (the PCA delta "
                "is signed; integer wraparound would corrupt pixels)")
        return x + delta.to(device=x.device, dtype=x.dtype)
    return fn


def random_brightness_maker(min_factor=0.0, max_factor=0.0):
    return lambda x: x * _host_uniform(min_factor, max_factor)


def _luma(x):
    return torch.as_tensor(LUMA, device=x.device).to(x.dtype)


def random_contrast_maker(min_factor=0.0, max_factor=0.0):
    def fn(x):
        f = _host_uniform(min_factor, max_factor)
        gray_mean = torch.mean(torch.sum(x * _luma(x), dim=-1, keepdim=True),
                               dim=(-3, -2), keepdim=True)
        return x * f + gray_mean * (1.0 - f)
    return fn


def random_saturation_maker(min_factor=0.0, max_factor=0.0):
    def fn(x):
        f = _host_uniform(min_factor, max_factor)
        gray = torch.sum(x * _luma(x), dim=-1, keepdim=True)
        return x * f + gray * (1.0 - f)
    return fn


def random_hue_maker(min_factor=0.0, max_factor=0.0):
    def fn(x):
        m = hue_rotation_matrix(_host_uniform(min_factor, max_factor))
        return torch.einsum("...c,dc->...d", x, torch.as_tensor(
            m, device=x.device).to(x.dtype))
    return fn


register_op("_image_to_tensor", to_tensor_maker)
register_op("_image_normalize", normalize_maker)
register_op("_image_flip_left_right", flip_lr_maker)
register_op("_image_flip_top_bottom", flip_tb_maker)
register_op("_image_random_flip_left_right", random_flip_lr_maker)
register_op("_image_random_flip_top_bottom", random_flip_tb_maker)
register_op("_image_resize", resize_maker)
register_op("_image_crop", crop_maker)
register_op("_image_adjust_lighting", adjust_lighting_maker)
register_op("_image_random_brightness", random_brightness_maker)
register_op("_image_random_contrast", random_contrast_maker)
register_op("_image_random_saturation", random_saturation_maker)
register_op("_image_random_hue", random_hue_maker)
