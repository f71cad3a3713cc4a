"""Sliding-window (banded) attention: ``_contrib_sldwin_atten_score``,
``_contrib_sldwin_atten_mask_like`` and ``_contrib_sldwin_atten_context``
(with their ``_sldwin_atten_*`` aliases).

Counterpart of ``mxnet_tpu/ndarray/ops_sldwin.py``, with its semantics:
query, key and value are (B, L, H, D); ``dilation`` is an (H,) integer
tensor input (one dilation a head); scores and masks are (B, L, H, W),
W = 2w+1 (``symmetric``) or w+1 (one-sided, the keys at and before the
query).  Band slot ``s`` of query row ``l`` in head ``h`` is key row
``l + offset[s] * dilation[h]``; a slot whose row falls outside [0, L)
holds an exact zero in the score and a 0 in the mask.  ``mask_like``
marks a slot live when its key row and its query row are both below the
sequence's ``valid_length``; it is not differentiable.

The JAX package gathers the whole (B, H, L, W, D) band of K (and of V)
and contracts it in one einsum, and its autodiff keeps that band for the
backward pass.  At Longformer-base's widths (L = 4096, W = 513, H = 12,
D = 64) the band is 1.61 G elements, 6.46 GB in fp32, for each of K and
V in every layer.  So here the score and context ops are autograd
Functions that save only their (B, L, H, D) inputs and, for the context,
its (B, L, H, W) scores, and build the band chunk by chunk over L
(``CHUNK_BYTES`` of band at a time), in the forward and again in the
backward:

- score ``s = band(q . k)``: ``dq = context(ds, k)``, and ``dk`` is a
  gather over the mirrored band: key row ``j`` receives from query rows
  ``j - offset[s] * dilation``, each through its own slot ``s``;
- context ``c = band(s . v)``: ``ds = score(dc, v)``, and ``dv`` is the
  mirrored gather of ``s`` and ``dc``.

Each gradient is a gather, never a scatter-add, so two runs give the
same bits on the card.  ``direct_score``/``direct_context`` are the JAX
package's formula in torch (the whole band, autograd through it): the
plain versions the tests and ``chip_smoke.py`` hold the ops against.
"""
from __future__ import annotations

import torch

from .register import register_op

__all__ = ["sldwin_score", "sldwin_context", "sldwin_mask_like",
           "direct_score", "direct_context", "CHUNK_BYTES"]

#: bytes of gathered band a chunk of query rows may take
CHUNK_BYTES = 256 << 20


def _offsets(w: int, symmetric: bool, device) -> torch.Tensor:
    """The band's offsets, -w..w (or -w..0), made on ``device`` (no host
    copy, so a CUDA graph can capture it)."""
    n = 2 * w + 1 if symmetric else w + 1
    return torch.arange(n, dtype=torch.int64, device=device) - w


def _rows(lo: int, hi: int, length: int, dilation: torch.Tensor,
          offs: torch.Tensor, sign: int = 1):
    """(H, hi - lo, W) band rows ``l + sign * offset * dilation[h]`` of
    query rows [lo, hi), clipped into range, and their validity."""
    pos = torch.arange(lo, hi, device=offs.device).reshape(1, -1, 1)
    dil = dilation.to(device=offs.device, dtype=torch.int64).reshape(
        -1, 1, 1)
    idx = pos + sign * offs.reshape(1, 1, -1) * dil
    valid = (idx >= 0) & (idx < length)
    return idx.clamp(0, length - 1), valid


def _gather(xt: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` (H, c, W) of ``xt`` (B, H, L, D): (B, H, c, W, D)."""
    b, h, _, d = xt.shape
    c, w = idx.shape[1], idx.shape[2]
    index = idx.reshape(1, h, c * w, 1).expand(b, h, c * w, d)
    return torch.take_along_dim(xt, index, dim=2).reshape(b, h, c, w, d)


def _chunk(b: int, h: int, w: int, d: int, itemsize: int) -> int:
    return max(1, CHUNK_BYTES // max(1, b * h * w * d * itemsize))


def _heads_first(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 1, 3).contiguous()


def _band_dot(q, k, dilation, w: int, symmetric: bool) -> torch.Tensor:
    """(B, L, H, W): each query row against its band of key rows."""
    b, length, h, d = q.shape
    offs = _offsets(w, symmetric, q.device)
    nw = offs.numel()
    qt, kt = _heads_first(q), _heads_first(k)
    out = q.new_empty((b, length, h, nw))
    step = _chunk(b, h, nw, d, q.element_size())
    for lo in range(0, length, step):
        hi = min(length, lo + step)
        idx, valid = _rows(lo, hi, length, dilation, offs)
        band = _gather(kt, idx)                          # (B, H, c, W, D)
        s = torch.einsum("bhld,bhlwd->bhlw", qt[:, :, lo:hi], band)
        s = s * valid.to(s.dtype)
        out[:, lo:hi] = s.permute(0, 2, 1, 3)
    return out


def _band_sum(s, x, dilation, w: int, symmetric: bool,
              mirrored: bool = False) -> torch.Tensor:
    """(B, L, H, D): each row's band of ``x`` rows weighed by its band of
    ``s``; ``mirrored``: row ``j`` takes the rows ``j - offset *
    dilation`` and their slot's weight (the transpose of the band)."""
    b, length, h, d = x.shape
    offs = _offsets(w, symmetric, x.device)
    nw = offs.numel()
    st, xt = _heads_first(s), _heads_first(x)            # (B, H, L, *)
    out = x.new_empty((b, length, h, d))
    step = _chunk(b, h, nw, d, x.element_size())
    for lo in range(0, length, step):
        hi = min(length, lo + step)
        idx, valid = _rows(lo, hi, length, dilation, offs,
                           -1 if mirrored else 1)
        band = _gather(xt, idx)                          # (B, H, c, W, D)
        if mirrored:
            index = idx.unsqueeze(0).expand(b, -1, -1, -1)
            weight = torch.take_along_dim(st, index, dim=2)
        else:
            weight = st[:, :, lo:hi]
        weight = weight * valid.to(weight.dtype)
        c = torch.einsum("bhlw,bhlwd->bhld", weight, band)
        out[:, lo:hi] = c.permute(0, 2, 1, 3)
    return out


class _Score(torch.autograd.Function):
    @staticmethod
    def forward(ctx, query, key, dilation, w, symmetric):
        ctx.save_for_backward(query, key, dilation)
        ctx.band = (w, symmetric)
        return _band_dot(query, key, dilation, w, symmetric)

    @staticmethod
    def backward(ctx, ds):
        query, key, dilation = ctx.saved_tensors
        w, symmetric = ctx.band
        ds = ds.contiguous()
        dq = dk = None
        if ctx.needs_input_grad[0]:
            dq = _band_sum(ds, key, dilation, w, symmetric)
        if ctx.needs_input_grad[1]:
            dk = _band_sum(ds, query, dilation, w, symmetric, mirrored=True)
        return dq, dk, None, None, None


class _Context(torch.autograd.Function):
    @staticmethod
    def forward(ctx, score, value, dilation, w, symmetric):
        ctx.save_for_backward(score, value, dilation)
        ctx.band = (w, symmetric)
        return _band_sum(score, value, dilation, w, symmetric)

    @staticmethod
    def backward(ctx, dc):
        score, value, dilation = ctx.saved_tensors
        w, symmetric = ctx.band
        dc = dc.contiguous()
        ds = dv = None
        if ctx.needs_input_grad[0]:
            ds = _band_dot(dc, value, dilation, w, symmetric)
        if ctx.needs_input_grad[1]:
            dv = _band_sum(score, dc, dilation, w, symmetric, mirrored=True)
        return ds, dv, None, None, None


def sldwin_score(query, key, dilation, w: int = 1,
                 symmetric: bool = True) -> torch.Tensor:
    """(B, L, H, W) scores of (B, L, H, D) ``query`` and ``key``."""
    return _Score.apply(query, key, dilation, int(w), bool(symmetric))


def sldwin_context(score, value, dilation, w: int = 1,
                   symmetric: bool = True) -> torch.Tensor:
    """(B, L, H, D): the (B, L, H, W) ``score`` applied to ``value``."""
    return _Context.apply(score, value, dilation, int(w), bool(symmetric))


def sldwin_mask_like(score, dilation, valid_length, w: int = 1,
                     symmetric: bool = True) -> torch.Tensor:
    """(B, L, H, W): 1 where the slot's key row and its query row are
    both below the sequence's ``valid_length``, in ``score``'s dtype."""
    b, length, h, _ = score.shape
    offs = _offsets(int(w), bool(symmetric), score.device)
    idx, valid = _rows(0, length, length, dilation, offs)       # (H, L, W)
    vl = valid_length.to(device=score.device).reshape(-1, 1, 1, 1) \
        .to(torch.int32)
    key_ok = valid.unsqueeze(0) & (idx.unsqueeze(0) < vl)
    q_ok = torch.arange(length, device=score.device).reshape(1, 1, -1, 1) \
        < vl
    return (key_ok & q_ok).to(score.dtype).permute(0, 2, 1, 3).contiguous()


def _direct_band(x, dilation, w: int, symmetric: bool):
    b, length, h, d = x.shape
    offs = _offsets(w, symmetric, x.device)
    idx, valid = _rows(0, length, length, dilation, offs)
    band = _gather(x.permute(0, 2, 1, 3), idx)
    return band * valid.reshape(1, h, length, -1, 1).to(band.dtype)


def direct_score(query, key, dilation, w: int = 1,
                 symmetric: bool = True) -> torch.Tensor:
    """The plain version: the JAX package's gather of the whole band and
    one einsum (``mxnet_tpu/ndarray/ops_sldwin.py:54-63``)."""
    band = _direct_band(key, dilation, int(w), bool(symmetric))
    s = torch.einsum("bhld,bhlwd->bhlw", query.permute(0, 2, 1, 3), band)
    return s.permute(0, 2, 1, 3)


def direct_context(score, value, dilation, w: int = 1,
                   symmetric: bool = True) -> torch.Tensor:
    """The plain version of the context op (:86-95)."""
    band = _direct_band(value, dilation, int(w), bool(symmetric))
    c = torch.einsum("bhlw,bhlwd->bhld", score.permute(0, 2, 1, 3), band)
    return c.permute(0, 2, 1, 3)


def _maker(fn):
    def maker(w=1, symmetric=True):
        def run(*tensors):
            return fn(*tensors, w=int(w), symmetric=bool(symmetric))
        return run
    return maker


def _register():
    register_op("_contrib_sldwin_atten_score", _maker(sldwin_score),
                aliases=("_sldwin_atten_score",))
    register_op("_contrib_sldwin_atten_mask_like", _maker(sldwin_mask_like),
                aliases=("_sldwin_atten_mask_like",), differentiable=False)
    register_op("_contrib_sldwin_atten_context", _maker(sldwin_context),
                aliases=("_sldwin_atten_context",))


_register()
