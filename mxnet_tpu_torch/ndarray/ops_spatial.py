"""Spatial warping and index arithmetic: ``GridGenerator``,
``BilinearSampler``, ``SpatialTransformer``, ``batch_take``,
``_ravel_multi_index`` and ``_unravel_index``.

Counterpart of ``mxnet_tpu/ndarray/ops_spatial.py`` (:16-126).  The JAX
package computes them in XLA outside any Pallas kernel; here they are
torch code with the JAX package's conventions:

- a sampling grid is ``(B, 2, H, W)``, its channels ``(x, y)`` in
  ``[-1, 1]``; ``GridGenerator("affine")`` maps the target's pixel
  centres (``linspace(-1, 1, n)`` each way, as ``jnp.linspace`` computes
  it: ``start * (1 - i / d) + stop * (i / d)``) through the ``(B, 6)``
  affine (elementwise, bit for bit the same on the card and the CPU),
  ``"warp"`` adds a flow in pixels to the identity grid;
- the sampler is the JAX package's gather-and-lerp: a grid point ``g``
  lands at ``(g + 1) (n - 1) / 2`` pixels, its four neighbours are
  gathered (zero outside the image) and mixed by the fractional parts.
  The floors are ``torch.floor`` calls, so a ``TorchFunctionMode`` can
  record them on one device and hand them to a run on another
  (``chip_smoke.py``'s ``SamplerDecisions``).  The gradient reaches the
  image (a scatter-add: atomic, so not bit for bit repeatable on the
  card) and the grid;
- ``SpatialTransformer`` is the affine grid at ``target_shape`` followed
  by the sampler;
- ``_ravel_multi_index``/``_unravel_index`` take and give indices in the
  input's dtype and take no gradient.
"""
from __future__ import annotations

import numpy as np
import torch

from .register import register_op, simple_op


def jnp_linspace(start: float, stop: float, num: int, endpoint=True,
                 dtype=torch.float32, device=None) -> torch.Tensor:
    """``jnp.linspace``'s values: ``start * (1 - s) + stop * s`` with
    ``s = i / div`` in ``dtype``, the last value ``stop`` itself."""
    num = int(num)
    div = num - 1 if endpoint else num
    if num <= 1:
        return torch.full((num,), float(start), dtype=dtype, device=device)
    # fills, not host copies (a CUDA graph can capture them); the divisor
    # a tensor, so the card divides as the CPU does (a Python number would
    # make it multiply by the reciprocal)
    lo = torch.full((), float(start), dtype=dtype, device=device)
    hi = torch.full((), float(stop), dtype=dtype, device=device)
    step = torch.arange(div, dtype=dtype, device=device) / torch.full(
        (), float(div), dtype=dtype, device=device)
    out = lo * (1 - step) + hi * step
    if endpoint:
        out = torch.cat([out, hi.reshape(1)])
    return out


def _identity_grid(h: int, w: int, like: torch.Tensor):
    ys = jnp_linspace(-1.0, 1.0, h, dtype=like.dtype, device=like.device)
    xs = jnp_linspace(-1.0, 1.0, w, dtype=like.dtype, device=like.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return gx, gy


def affine_grid(theta: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``theta`` (B, 6) -> the grid (B, 2, h, w) in [-1, 1]: ``t0 x + t1 y
    + t2`` and ``t3 x + t4 y + t5`` as elementwise products and sums, so
    the card rounds each point as the CPU does (a matmul's order and
    fused multiply-adds are the library's); the gradient in ``theta`` is
    then a reduction over the points."""
    gx, gy = _identity_grid(h, w, theta)
    t = theta.reshape(-1, 6, 1, 1)
    return torch.stack([t[:, 0] * gx + t[:, 1] * gy + t[:, 2],
                        t[:, 3] * gx + t[:, 4] * gy + t[:, 5]], dim=1)


def bilinear_sample(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """``img`` (B, C, H, W) sampled at ``grid`` (B, 2, HO, WO)."""
    b, c, h, w = img.shape
    ho, wo = grid.shape[2:]
    gx = (grid[:, 0] + 1.0) * (w - 1) / 2.0
    gy = (grid[:, 1] + 1.0) * (h - 1) / 2.0
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    lx = (gx - x0)[:, None]
    ly = (gy - y0)[:, None]
    flat = img.reshape(b, c, h * w)

    def at(yy, xx):
        inb = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        yi = yy.clamp(0, h - 1).long()
        xi = xx.clamp(0, w - 1).long()
        idx = (yi * w + xi).reshape(b, 1, ho * wo).expand(b, c, ho * wo)
        v = flat.gather(2, idx).reshape(b, c, ho, wo)
        return torch.where(inb[:, None], v, torch.zeros_like(v))

    v00 = at(y0, x0)
    v01 = at(y0, x0 + 1)
    v10 = at(y0 + 1, x0)
    v11 = at(y0 + 1, x0 + 1)
    return (v00 * (1 - ly) * (1 - lx) + v01 * (1 - ly) * lx +
            v10 * ly * (1 - lx) + v11 * ly * lx)


def grid_generator_maker(transform_type="affine", target_shape=(0, 0)):
    th, tw = int(target_shape[0]), int(target_shape[1])

    def fn(data):
        if transform_type == "affine":
            return affine_grid(data, th, tw)
        h, w = data.shape[2:]
        gx, gy = _identity_grid(h, w, data)
        ident = torch.stack([gx, gy])
        norm = torch.stack([data[:, 0] * 2.0 / max(w - 1, 1),
                            data[:, 1] * 2.0 / max(h - 1, 1)], dim=1)
        return ident[None] + norm
    return fn


def bilinear_sampler_maker(cudnn_off=None):
    return bilinear_sample


def spatial_transformer_maker(target_shape=(0, 0), transform_type="affine",
                              sampler_type="bilinear", cudnn_off=None):
    th, tw = int(target_shape[0]), int(target_shape[1])

    def fn(data, loc):
        return bilinear_sample(data, affine_grid(loc, th, tw))
    return fn


def _batch_take(a, indices):
    flat = a.reshape(a.shape[0], -1)
    return flat.gather(1, indices.reshape(-1, 1).long())[:, 0]


def _strides(shape):
    dims = tuple(int(s) for s in shape)
    return np.cumprod((1,) + dims[::-1][:-1])[::-1].tolist()


def ravel_multi_index_maker(shape=None):
    strides = _strides(shape)

    def fn(idx):
        st = torch.as_tensor(strides, dtype=idx.dtype, device=idx.device)
        return (idx * st[:, None]).sum(0).to(idx.dtype)
    return fn


def unravel_index_maker(shape=None):
    strides = _strides(shape)

    def fn(idx):
        outs, rem = [], idx
        for s in strides:
            outs.append(rem // s)
            rem = rem % s
        return torch.stack(outs).to(idx.dtype)
    return fn


register_op("GridGenerator", grid_generator_maker,
            aliases=("grid_generator",))
register_op("BilinearSampler", bilinear_sampler_maker,
            aliases=("bilinear_sampler",))
register_op("SpatialTransformer", spatial_transformer_maker,
            aliases=("spatial_transformer",))
simple_op("batch_take", _batch_take)
register_op("_ravel_multi_index", ravel_multi_index_maker,
            aliases=("ravel_multi_index",), differentiable=False)
register_op("_unravel_index", unravel_index_maker,
            aliases=("unravel_index",), differentiable=False)
