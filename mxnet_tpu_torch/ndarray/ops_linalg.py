"""Linear algebra: MXNet's ``linalg_*`` operators (``la_op.cc``).

Counterpart of ``mxnet_tpu/ndarray/ops_linalg.py`` (:15-165):
``linalg_gemm``, ``potrf``, ``potri``, ``trsm``, ``trmm``, ``syrk``,
``gelqf``, ``sumlogdiag``, ``extractdiag``, ``makediag``,
``extracttrian``, ``maketrian``, ``inverse``, ``det``, ``slogdet``,
``syevd`` and ``khatri_rao``, each also under its ``_linalg_*`` name
(``_linalg_gemm2`` too, for ``ops_matrix``'s ``linalg_gemm2``).  The JAX
package computes them in XLA outside any Pallas kernel; here they are
``torch.linalg`` (cuSOLVER and cuBLAS on the card, LAPACK on the CPU).
Leading axes are batch axes.  The conventions are the JAX package's:

- ``potrf`` gives the lower factor (``lower=False``: its transpose);
  ``potri`` the inverse ``L^-T L^-1`` from a factor;
- ``trsm``/``trmm`` read only the ``lower`` (or upper) triangle of ``A``;
  ``transpose`` applies ``A^T``, ``rightside`` puts ``A`` on the right,
  and ``alpha`` scales ``B``;
- ``gelqf`` returns ``(Q, L)`` with ``A = L Q`` (the QR of ``A^T``);
- ``syevd`` reads the lower triangle only and returns ``(U, w)``: the
  eigenvectors as the rows of ``U``, the eigenvalues ascending; its
  gradient is the JAX package's (not symmetrised);
- ``maketrian`` inverts ``extracttrian`` (the triangle's side from the
  count of entries, widened by ``|offset|``), ``makediag`` puts a vector
  on the ``offset`` diagonal;
- ``khatri_rao`` is the column-wise Kronecker product of its inputs.

Signs of the factors of ``gelqf`` and ``syevd`` are LAPACK's or
cuSOLVER's: the card and the CPU may differ by the sign of a row.
"""
from __future__ import annotations

import numpy as np
import torch

from . import ops_matrix  # noqa: F401  (linalg_gemm2, aliased below)
from .register import add_alias, register_op, simple_op


def _t(a: torch.Tensor) -> torch.Tensor:
    return a.transpose(-1, -2)


def gemm_maker(transpose_a=False, transpose_b=False, alpha=1.0, beta=1.0,
               axis=-2):
    def fn(a, b, c):
        av = _t(a) if transpose_a else a
        bv = _t(b) if transpose_b else b
        return alpha * torch.matmul(av, bv) + beta * c
    return fn


def potrf_maker(lower=True):
    def fn(a):
        low = torch.linalg.cholesky(a)
        return low if lower else _t(low).contiguous()
    return fn


def potri_maker(lower=True):
    def fn(f):
        low = f if lower else _t(f)
        eye = torch.eye(low.shape[-1], dtype=low.dtype,
                        device=low.device).expand(low.shape)
        linv = torch.linalg.solve_triangular(low, eye, upper=False)
        return torch.matmul(_t(linv), linv)
    return fn


def trsm_maker(transpose=False, rightside=False, lower=True, alpha=1.0):
    def fn(a, b):
        tri, upper = (_t(a), lower) if transpose else (a, not lower)
        return torch.linalg.solve_triangular(tri, alpha * b, upper=upper,
                                             left=not rightside)
    return fn


def trmm_maker(transpose=False, rightside=False, lower=True, alpha=1.0):
    def fn(a, b):
        tri = torch.tril(a) if lower else torch.triu(a)
        if transpose:
            tri = _t(tri)
        return alpha * (torch.matmul(b, tri) if rightside
                        else torch.matmul(tri, b))
    return fn


def syrk_maker(transpose=False, alpha=1.0):
    def fn(a):
        return alpha * (torch.matmul(_t(a), a) if transpose
                        else torch.matmul(a, _t(a)))
    return fn


def gelqf_maker():
    def fn(a):
        q, r = torch.linalg.qr(_t(a))
        return _t(q).contiguous(), _t(r).contiguous()
    return fn


def extractdiag_maker(offset=0):
    return lambda a: torch.diagonal(a, offset=int(offset), dim1=-2,
                                    dim2=-1).contiguous()


def makediag_maker(offset=0):
    off = int(offset)

    def fn(a):
        n = a.shape[-1] + abs(off)
        out = a.new_zeros(a.shape[:-1] + (n, n))
        idx = torch.arange(a.shape[-1], device=a.device)
        out[..., idx + max(-off, 0), idx + max(off, 0)] = a
        return out
    return fn


def _tri(n: int, offset: int, lower: bool):
    rows, cols = np.tril_indices(n, k=offset) if lower else \
        np.triu_indices(n, k=offset)
    return rows, cols


def extracttrian_maker(offset=0, lower=True):
    def fn(a):
        rows, cols = _tri(a.shape[-1], int(offset), lower)
        dev = a.device
        return a[..., torch.as_tensor(rows, device=dev),
                 torch.as_tensor(cols, device=dev)]
    return fn


def maketrian_maker(offset=0, lower=True):
    off = int(offset)

    def fn(a):
        k = a.shape[-1]
        n = int(round((np.sqrt(8 * k + 1) - 1) / 2))
        if lower and off < 0 or not lower and off > 0:
            n += abs(off)
        rows, cols = _tri(n, off, lower)
        dev = a.device
        out = a.new_zeros(a.shape[:-1] + (n, n))
        out[..., torch.as_tensor(rows, device=dev),
            torch.as_tensor(cols, device=dev)] = a
        return out
    return fn


class _Syevd(torch.autograd.Function):
    """``eigh`` of the lower triangle: ``(U, w)``, the eigenvectors as rows.
    The backward is the JAX package's (the transpose of ``jnp.linalg.eigh``'s
    JVP with ``symmetrize_input=False``): ``V (diag(gw) + F * (V^T gV))
    V^T``, ``F_ij = 1 / (w_j - w_i)`` off the diagonal; torch's own
    gradient is its symmetric part."""

    @staticmethod
    def forward(ctx, a):
        w, v = torch.linalg.eigh(a, UPLO="L")
        ctx.save_for_backward(w, v)
        return _t(v).contiguous(), w

    @staticmethod
    def backward(ctx, g_u, g_w):
        w, v = ctx.saved_tensors
        inner = torch.zeros_like(v)
        if g_u is not None:
            eye = torch.eye(w.shape[-1], dtype=w.dtype, device=w.device)
            f = 1.0 / (eye + w[..., None, :] - w[..., :, None]) - eye
            inner = f * torch.matmul(_t(v), _t(g_u))
        if g_w is not None:
            inner = inner + torch.diag_embed(g_w)
        return torch.matmul(torch.matmul(v, inner), _t(v))


def _khatri_rao(*mats):
    out = mats[0]
    for m in mats[1:]:
        out = (out[:, None, :] * m[None, :, :]).reshape(-1, out.shape[-1])
    return out


def _register():
    register_op("linalg_gemm", gemm_maker)
    register_op("linalg_potrf", potrf_maker)
    register_op("linalg_potri", potri_maker)
    register_op("linalg_trsm", trsm_maker)
    register_op("linalg_trmm", trmm_maker)
    register_op("linalg_syrk", syrk_maker)
    register_op("linalg_gelqf", gelqf_maker)
    simple_op("linalg_sumlogdiag", lambda a: torch.log(
        torch.diagonal(a, dim1=-2, dim2=-1)).sum(-1))
    register_op("linalg_extractdiag", extractdiag_maker)
    register_op("linalg_makediag", makediag_maker)
    register_op("linalg_extracttrian", extracttrian_maker)
    register_op("linalg_maketrian", maketrian_maker)
    simple_op("linalg_inverse", torch.linalg.inv)
    simple_op("linalg_det", torch.linalg.det)
    simple_op("linalg_slogdet", lambda a: tuple(torch.linalg.slogdet(a)))
    simple_op("linalg_syevd", _Syevd.apply)
    simple_op("khatri_rao", _khatri_rao)
    for base in ("gemm", "gemm2", "potrf", "potri", "trsm", "trmm",
                 "syrk", "gelqf", "sumlogdiag", "extractdiag", "makediag",
                 "extracttrian", "maketrian", "inverse", "det", "slogdet",
                 "syevd"):
        add_alias(f"linalg_{base}", f"_linalg_{base}")


_register()
