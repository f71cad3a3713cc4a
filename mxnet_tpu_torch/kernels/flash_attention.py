"""Flash attention forward: a hand-written CUDA kernel for Hopper and its
plain PyTorch version.

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
launches in ``flash_attention.launches``.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from ..base import MXNetError

__all__ = ["flash_attention", "flash_attention_plain"]

BLOCK_K = 128           # key chunk of the plain version (the TPU tile)
_NEG_INF = -1e30
_KERNEL_DIMS = (32, 64, 128)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_BH = 65535         # the kernel's grid.y
_count_lock = threading.Lock()


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, vl: torch.Tensor, causal: bool,
                          scale: float) -> torch.Tensor:
    """The plain PyTorch version: online softmax over BLOCK_K-key chunks,
    written like the TPU kernel's ``_chunked_reference``.  q is
    ``(BH, Lq, D)``, k/v ``(BH, Lk, D)``, vl ``(BH,)`` float32."""
    bh, lq, d = q.shape
    lk = k.shape[1]
    qf = q.float() * scale
    kf, vf = k.float(), v.float()
    vl_eff = torch.clamp(vl.float(), max=float(lk))            # (BH,)
    q_idx = torch.arange(lq, device=q.device)
    m = torch.full((bh, lq), _NEG_INF, device=q.device)
    l = torch.zeros((bh, lq), device=q.device)
    acc = torch.zeros((bh, lq, d), device=q.device)
    for k0 in range(0, lk, BLOCK_K):
        k_blk, v_blk = kf[:, k0:k0 + BLOCK_K], vf[:, k0:k0 + BLOCK_K]
        k_ids = torch.arange(k0, k0 + k_blk.shape[1], device=q.device)
        kmask = (k_ids.float()[None, :] < vl_eff[:, None])[:, None, :]
        mask = kmask
        if causal:
            mask = mask & (k_ids[None, None, :]
                           <= q_idx[None, :, None] + (lk - lq))
        s = torch.where(mask, torch.bmm(qf, k_blk.transpose(1, 2)),
                        torch.tensor(_NEG_INF, device=q.device))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        dead = m_new <= _NEG_INF * 0.5
        p = torch.where(dead[..., None], kmask.float().expand_as(p), p)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.bmm(p, v_blk)
        m = m_new
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / l[..., None]).to(q.dtype)


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
    with _count_lock:
        flash_attention.launches += 1
    return out


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
    launches the kernel, which takes D in {32, 64, 128}, float32 or
    bfloat16, q/k/v starting on a 16-byte boundary and batch*heads up to
    65535, and raises on anything else (a contiguous view at an unaligned
    offset included).  The kernel has no backward
    yet: on a CUDA tensor with grad mode on and q, k or v requiring grad
    the wrapper raises rather than return a result without a gradient."""
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
        vl = vl.contiguous()
    if _on_card(q):
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in tensors):
            raise MXNetError(
                "flash_attention: the CUDA kernel has no backward yet (it "
                "comes with the BERT-training slice); on the card call it "
                "without gradients (torch.no_grad/inference_mode) or set "
                "MXNET_ATTENTION_KERNEL=xla")
        out = _launch(q, k, v, vl, causal, scale)
    elif q.device.type == "cpu":
        out = flash_attention_plain(q, k, v, vl, causal, scale)
    else:
        raise MXNetError(f"flash_attention: no kernel for device {q.device}")
    return out.reshape(b, h, lq, d) if four_d else out


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


flash_attention.launches = 0
