"""Flash attention: a hand-written CUDA forward kernel for Hopper, its
plain PyTorch version, and a chunked PyTorch backward.

Replaces the Pallas TPU kernel ``mxnet_tpu/kernels/flash_attention.py``
(``_build_call``): ``softmax(scale * Q Kᵀ + mask) V`` with an online
softmax, fp32 accumulation, and no (Lq, Lk) score matrix in device memory.

Semantics, shared by the kernel (``csrc/flash_attention.cu``) and the plain
version below, exactly as the TPU kernel has them:

- ``scale`` multiplies the fp32 scores (the plain version scales q in
  fp32 before the product: the two differ by fp32 rounding);
- key ``k`` of row ``bh`` is valid iff ``float(k) < min(valid_len[bh], Lk)``;
- ``causal`` also masks ``k > q + (Lk - Lq)`` (bottom-right aligned, from
  the unpadded lengths);
- a row with no valid key under both masks (a "dead" row) takes the
  key-length mask itself as its weights, i.e. uniform attention over the
  valid keys; a row whose weights sum to 0 divides by 1 and outputs 0;
- the output has the input dtype.

``flash_attention`` is the wrapper.  On a CPU tensor it runs the plain
version; on a CUDA tensor it launches the kernel or raises.  It counts its
launches in ``flash_attention.launches`` (and, by input dtype, in
``flash_attention.launches_by_dtype``), through ``counters.bump``: a
launch captured into a CUDA graph counts at each replay.  The backward is torch code on
both devices, as the JAX package's is jnp (a custom VJP over
``_chunked_reference``, not a Pallas kernel): it recomputes the
probabilities one BLOCK_K-key chunk at a time, so neither direction
keeps an (Lq, Lk) matrix.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..base import MXNetError
from . import counters

__all__ = ["flash_attention", "flash_attention_backward",
           "flash_attention_plain"]

BLOCK_K = 128           # key chunk of the plain version (the TPU tile)
_NEG_INF = -1e30
_KERNEL_DIMS = (32, 64, 128)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1,
                  torch.float16: 2}
_MAX_BH = 65535         # the kernel's grid.y


def _chunk_scores(qs, k_blk, k0, vl_eff, causal, lq, lk):
    """Masked scores ``(BH, Lq, n)`` of one key chunk starting at ``k0``
    (masked entries ``_NEG_INF``) and its key-length mask ``(BH, 1, n)``.
    ``qs`` is q already scaled, in the accumulation dtype."""
    dev = qs.device
    k_ids = torch.arange(k0, k0 + k_blk.shape[1], device=dev)
    kmask = (k_ids.to(vl_eff.dtype)[None, :] < vl_eff[:, None])[:, None, :]
    mask = kmask
    if causal:
        q_idx = torch.arange(lq, device=dev)
        mask = mask & (k_ids[None, None, :]
                       <= q_idx[None, :, None] + (lk - lq))
    s = torch.where(mask, torch.bmm(qs, k_blk.transpose(1, 2)), _NEG_INF)
    return s, kmask


def _online_softmax(qs, kf, vf, vl_eff, causal):
    """The forward's loop over BLOCK_K-key chunks: each row's running max
    ``m``, denominator ``l`` and unnormalised output ``acc``, in the
    accumulation dtype, with the dead-row rule."""
    bh, lq, d = qs.shape
    lk = kf.shape[1]
    m = torch.full((bh, lq), _NEG_INF, dtype=qs.dtype, device=qs.device)
    l = torch.zeros((bh, lq), dtype=qs.dtype, device=qs.device)
    acc = torch.zeros((bh, lq, d), dtype=qs.dtype, device=qs.device)
    for k0 in range(0, lk, BLOCK_K):
        k_blk, v_blk = kf[:, k0:k0 + BLOCK_K], vf[:, k0:k0 + BLOCK_K]
        s, kmask = _chunk_scores(qs, k_blk, k0, vl_eff, causal, lq, lk)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        dead = m_new <= _NEG_INF * 0.5
        p = torch.where(dead[..., None], kmask.to(p.dtype).expand_as(p), p)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.bmm(p, v_blk)
        m = m_new
    # a row whose weights sum to 0 divides by 1
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    return m, l, acc


def _prepare(q, k, v, vl, scale):
    """q scaled, k, v and the clamped lengths in the accumulation dtype:
    fp32 for fp32/bf16/fp16 inputs, float64 for float64 (the backward's
    reference runs and ``gradcheck``)."""
    acc = torch.promote_types(q.dtype, torch.float32)
    lk = k.shape[1]
    vl_eff = torch.clamp(vl.to(acc), max=float(lk))            # (BH,)
    return q.to(acc) * scale, k.to(acc), v.to(acc), vl_eff


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, vl: torch.Tensor, causal: bool,
                          scale: float) -> torch.Tensor:
    """The plain PyTorch version: online softmax over BLOCK_K-key chunks,
    written like the TPU kernel's ``_chunked_reference``.  q is
    ``(BH, Lq, D)``, k/v ``(BH, Lk, D)``, vl ``(BH,)`` float32."""
    qs, kf, vf, vl_eff = _prepare(q, k, v, vl, scale)
    _, l, acc = _online_softmax(qs, kf, vf, vl_eff, causal)
    return (acc / l[..., None]).to(q.dtype)


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, vl: torch.Tensor, causal: bool,
                             scale: float, dout: torch.Tensor):
    """Gradients ``(dq, dk, dv)`` of :func:`flash_attention_plain` for the
    output gradient ``dout``, in two passes over BLOCK_K-key chunks, so no
    ``(Lq, Lk)`` matrix is built: pass 1 recomputes each row's ``m``,
    ``l`` and output in the accumulation dtype; pass 2 recomputes each
    chunk's probabilities ``p = exp(s - m) / l`` and takes

        dV = pᵀ·dO,   dP = dO·Vᵀ,   dS = p ∘ (dP − rowsum(dO ∘ O)),
        dQ += scale·dS·K,   dK = scale·dSᵀ·Q.

    The semantics are those of ``jax.vjp`` of the TPU kernel's
    ``_chunked_reference``: masked keys take no weight; a dead row's
    weights are its key mask, which does not depend on the scores, so
    its dS is 0 while its dV still flows; a row whose weights sum to 0
    outputs 0 and passes no gradient.  Gradients come back in the inputs'
    dtypes, accumulated in fp32 (float64 for float64 inputs).  Both
    devices run this function."""
    lq, lk = q.shape[1], k.shape[1]
    qs, kf, vf, vl_eff = _prepare(q, k, v, vl, scale)
    m, l, acc = _online_softmax(qs, kf, vf, vl_eff, causal)
    do = dout.to(qs.dtype)
    delta = (do * (acc / l[..., None])).sum(dim=-1, keepdim=True)
    dead = (m <= _NEG_INF * 0.5)[..., None]
    inv_l = (1.0 / l)[..., None]
    dq = torch.zeros_like(qs)
    dk = torch.empty_like(kf)
    dv = torch.empty_like(vf)
    for k0 in range(0, lk, BLOCK_K):
        k_blk, v_blk = kf[:, k0:k0 + BLOCK_K], vf[:, k0:k0 + BLOCK_K]
        s, kmask = _chunk_scores(qs, k_blk, k0, vl_eff, causal, lq, lk)
        # in place where it can be: at most two chunk-sized temporaries
        # live at once (p, then dS)
        p = torch.where(dead, kmask.to(s.dtype),
                        s.sub_(m[..., None]).exp_()).mul_(inv_l)
        del s
        dv[:, k0:k0 + BLOCK_K] = torch.bmm(p.transpose(1, 2), do)
        ds = torch.bmm(do, v_blk.transpose(1, 2)).sub_(delta).mul_(p)
        del p
        ds.masked_fill_(dead, 0.0)
        dq += torch.bmm(ds, k_blk)
        dk[:, k0:k0 + BLOCK_K] = torch.bmm(ds.transpose(1, 2), qs)
    return (dq.mul_(scale).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


_fn = None


def _kernel():
    """The C entry point, built and bound at first use."""
    global _fn
    if _fn is None:
        from . import _build
        fn = _build.load("flash_attention").mxtpu_flash_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + \
            [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _launch(q, k, v, vl, causal: bool, scale: float) -> torch.Tensor:
    """Launch ``csrc/flash_attention.cu`` on q's current CUDA stream."""
    bh, lq, d = q.shape
    lk = k.shape[1]
    if d not in _KERNEL_DIMS:
        raise MXNetError(f"flash_attention kernel: head dim {d} not in "
                         f"{_KERNEL_DIMS}")
    if q.dtype not in _KERNEL_DTYPES:
        raise MXNetError(f"flash_attention kernel: dtype {q.dtype} not in "
                         f"{tuple(_KERNEL_DTYPES)}")
    if bh > _MAX_BH:
        raise MXNetError(f"flash_attention kernel: batch*heads {bh} > "
                         f"{_MAX_BH}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise MXNetError(
                f"flash_attention kernel: {name} starts {t.data_ptr() % 16} "
                f"bytes past a 16-byte boundary (storage offset "
                f"{t.storage_offset()}); its 16-byte copies need aligned "
                f"rows: pass a copy ({name}.clone())")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = _kernel()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), vl.data_ptr(),
             out.data_ptr(), bh, lq, lk, d, _KERNEL_DTYPES[q.dtype],
             int(causal), float(scale), stream)
    if err != 0:
        raise MXNetError(f"flash_attention kernel launch failed: CUDA "
                         f"error {err}")
    counters.bump(flash_attention, "launches")
    counters.bump(flash_attention.launches_by_dtype, str(q.dtype))
    return out


class _FlashAttention(torch.autograd.Function):
    """One differentiable node: the forward launches the kernel on a CUDA
    tensor (the plain version on a CPU tensor) under no grad; the backward
    is :func:`flash_attention_backward` on either device.  q, k, v and
    the lengths are saved; nothing of size ``(Lq, Lk)`` is.  ``vl`` takes
    no gradient (a mask, not a weight)."""

    @staticmethod
    def forward(ctx, q, k, v, vl, causal, scale):
        if _on_card(q):
            out = _launch(q, k, v, vl, causal, scale)
        elif q.device.type == "cpu":
            out = flash_attention_plain(q, k, v, vl, causal, scale)
        else:
            raise MXNetError(f"flash_attention: no kernel for device "
                             f"{q.device}")
        ctx.save_for_backward(q, k, v, vl)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, vl = ctx.saved_tensors
        # a named range, so that a profile can tell these torch ops apart
        with torch.profiler.record_function("flash_attention_backward"):
            dq, dk, dv = flash_attention_backward(q, k, v, vl, ctx.causal,
                                                  ctx.scale, dout)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    valid_len: Optional[torch.Tensor] = None,
                    causal: bool = False, scale: Optional[float] = None
                    ) -> torch.Tensor:
    """Tiled attention ``softmax(scale * Q Kᵀ + mask) V``, with the
    signature of the ``flash_attention`` op.

    q/k/v are ``(B, H, L, D)`` or ``(BH, L, D)``, contiguous, on one device
    and of one dtype.  ``valid_len`` of shape ``(B,)`` or ``(B*H,)`` masks
    keys at positions ``>= valid_len[i]``; a ``(B,)`` vector is repeated
    b-major to ``(B*H,)``.  ``scale`` defaults to ``1/sqrt(D)``.

    On the CPU this runs :func:`flash_attention_plain`; on a CUDA tensor it
    launches the kernel, which takes D in {32, 64, 128}, float32,
    bfloat16 or float16, q/k/v starting on a 16-byte boundary and
    batch*heads up to 65535, and raises on anything else (a contiguous
    view at an unaligned offset included).  It is differentiable in q, k
    and v on both devices (:class:`_FlashAttention`, whose backward,
    :func:`flash_attention_backward`, recomputes the probabilities chunk
    by chunk in torch); it records a node when grad mode is on and an
    input requires grad, as any torch op does.  On ``NDArray``s (``mx.nd``)
    it runs on their tensors and returns an ``NDArray``."""
    if not isinstance(q, torch.Tensor):
        from ..ndarray.register import call_on_tensors
        return call_on_tensors(flash_attention, (q, k, v, valid_len, causal,
                                                 scale), {})
    tensors = (q, k, v)
    if len({t.device for t in tensors}) != 1:
        raise MXNetError("flash_attention: q, k, v on different devices")
    if len({t.dtype for t in tensors}) != 1:
        raise MXNetError("flash_attention: q, k, v of different dtypes")
    if not all(t.is_contiguous() for t in tensors):
        raise MXNetError("flash_attention: q, k, v must be contiguous")
    four_d = q.dim() == 4
    if four_d:
        b, h, lq, d = q.shape
        q = q.reshape(b * h, lq, d)
        k = k.reshape(b * h, k.shape[2], d)
        v = v.reshape(b * h, v.shape[2], d)
    bh, lq, d = q.shape
    lk = k.shape[1]
    if scale is None:
        scale = 1.0 / d ** 0.5
    if valid_len is None:
        vl = torch.full((bh,), float(lk), device=q.device)
    else:
        vl = torch.as_tensor(valid_len, device=q.device).reshape(-1).float()
        if vl.shape[0] != bh:
            if bh % vl.shape[0]:
                raise MXNetError(f"valid_len length {vl.shape[0]} does not "
                                 f"divide batch*heads {bh}")
            vl = vl.repeat_interleave(bh // vl.shape[0])
        vl = vl.detach().contiguous()
    out = _FlashAttention.apply(q, k, v, vl, bool(causal), float(scale))
    return out.reshape(b, h, lq, d) if four_d else out


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


flash_attention.launches = 0
flash_attention.launches_by_dtype = {str(t): 0 for t in _KERNEL_DTYPES}
