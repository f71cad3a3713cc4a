"""Loss heads, finiteness probes and GluonNLP's fused attention products.

Counterpart of ``mxnet_tpu/ndarray/ops_misc.py``, for the ops of that
file the port has so far: ``all_finite``/``multi_all_finite`` (:66-84),
``softmax_cross_entropy`` (:87-94), the output layers
``LinearRegressionOutput``, ``MAERegressionOutput``,
``LogisticRegressionOutput`` and ``SVMOutput`` (:96-141), the four
``_contrib_interleaved_matmul_*`` ops (:464-548), ``SoftmaxActivation``
(:611-619) and ``MakeLoss`` (:666-688).  The JAX package computes them
in XLA outside any Pallas kernel; here they are torch code.

- ``all_finite``/``multi_all_finite`` answer a 1-element float32 tensor
  on the data's device (1 when every element is finite): nothing is read
  back until the caller reads it.
- The output layers and ``MakeLoss`` are ``torch.autograd.Function``s
  whose backward ignores the head gradient, as MXNet's fused loss layers
  do and as the JAX package's custom VJPs do: the regression outputs
  hand ``data`` ``(y - t) * grad_scale`` (``sign(y - t)`` for MAE; ``y``
  is the sigmoid for the logistic one), ``SVMOutput`` the L2-SVM
  gradient (L1 with ``use_linear``) on the ±1 one-vs-rest encoding of
  the integer label, ``MakeLoss`` ``grad_scale``, divided by the batch
  for ``normalization="batch"`` and by the count of elements above
  ``valid_thresh`` (at least 1) for ``"valid"``.  The label takes no
  gradient.  A regression label with as many elements as ``data`` is
  read in ``data``'s shape, as MXNet reads it.
- The interleaved products take GluonNLP's layouts: projections
  ``(L, B, H * 3 * D)`` (or ``(L, B, H * 2 * D)`` for the encoder's
  keys and values) with q, k and v interleaved per head, attention
  matrices ``(B * H, Lq, Lk)``; ``qk`` scales q by ``1 / sqrt(D)``
  before the product, as the JAX op does, so a bf16 product rounds the
  same way.

The rest of that file: ``add_n`` (:57), ``IdentityAttachKLSparseReg``
(:172), the eight ``_random_pdf_*`` (:174-234), ``_contrib_fft``/
``_contrib_ifft`` (:240-256), ``_contrib_boolean_mask`` (:283),
``_contrib_arange_like``/``quadratic``/``gradientmultiplier``
(:301-326), ``Crop`` (:346), ``im2col``/``col2im`` (:386-409),
``histogram`` (:427), ``choose_element_0index``/``fill_element_0index``
(:444-451), ``split_v2`` (:469), ``_contrib_hawkesll`` (:608),
``_square_sum`` (:633), ``_hypot``/``_hypot_scalar`` (:642), the
``_logical_*`` binaries, the creation ops ``_zeros/_ones/_full/_arange/
_linspace/_eye`` (:711-746), ``_slice_assign``/``_slice_assign_scalar``
(:768-777), ``_onehot_encode`` (:788), ``_scatter_set_nd`` (:799),
``_copyto``, ``_set_value``, ``_identity_with_attr_like_rhs``,
``_rnn_param_concat`` (:830) and ``round_ste``/``sign_ste`` (:853-856):

- ``IdentityAttachKLSparseReg``'s backward adds the KL sparsity
  penalty's gradient, with ``rho_hat`` the batch mean of the sigmoid
  (the JAX package's departure: no moving average, ``momentum`` unused);
  ``gradientmultiplier`` scales the gradient, ``round_ste``/``sign_ste``
  pass it straight through (``round_ste`` rounds half away from 0);
- the pdfs broadcast their parameters over the sample's trailing axes
  and answer the density, or its log with ``is_log``;
- ``fft`` packs the complex result as interleaved ``(re, im)`` pairs on
  the last axis, ``ifft`` is unnormalised (``ifft(fft(x)) = d * x``);
- ``_contrib_boolean_mask`` and ``histogram`` without a range read values
  to the host (their output's shape): ``register.host_read``;
  ``histogram``'s counts are int32 with numpy's bins (the last one
  closed);
- ``im2col`` unfolds patches to ``(N, C * prod(kernel), L)``, channel
  major, any number of spatial axes; ``col2im`` is its adjoint, a sum of
  one strided slice per kernel offset (no scatter, so deterministic);
- ``split_v2`` takes ``sections`` or split indices (a leading 0 dropped,
  ``normalize_split_indices``) and returns one array for one part;
- ``_contrib_hawkesll`` is the JAX package's Ogata recursion over the
  events, one step per event position;
- the creation ops run on ``ctx`` (the current context if None);
  ``_linspace`` computes as ``jnp.linspace`` does;
- ``_scatter_set_nd``, ``_onehot_encode``, ``_set_value``, the
  ``_logical_*`` binaries (float32 0/1), ``_contrib_arange_like``,
  ``histogram`` and the creation ops take no gradient.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError, torch_dtype
from ..context import as_device
from .ops_spatial import jnp_linspace
from .ops_reduce import int32_result
from .register import host_read, register_op, simple_op


def normalize_split_indices(indices):
    """``split_v2``'s split points: MXNet's raw op passes the segments'
    starts (a leading 0 included), ``torch.tensor_split`` takes the points
    without it.  Shared with ``symbol/register.py`` (its output count)."""
    idx = list(indices)
    if idx and idx[0] == 0:
        idx = idx[1:]
    return idx


def all_finite_maker(init_output=True):
    def fn(data):
        return torch.isfinite(data.float()).all().float().reshape(1)
    return fn


def multi_all_finite_maker(num_arrays=1, init_output=True):
    def fn(*arrays):
        ok = torch.stack([torch.isfinite(a.float()).all() for a in arrays])
        return ok.all().float().reshape(1)
    return fn


def softmax_cross_entropy_maker():
    def fn(data, label):
        logp = torch.log_softmax(data, dim=1)
        picked = torch.take_along_dim(logp, label.long()[:, None], dim=1)
        return -picked.sum().reshape(1)
    return fn


class _OutputLayer(torch.autograd.Function):
    """``forward(x)`` as the layer's output; the backward of ``x`` is
    ``grad(y, label) * grad_scale`` whatever the head gradient, and the
    label takes none."""

    @staticmethod
    def forward(ctx, x, label, forward, grad, grad_scale):
        y = forward(x)
        ctx.save_for_backward(y, label)
        ctx.grad, ctx.grad_scale = grad, grad_scale
        return y

    @staticmethod
    def backward(ctx, _head):
        y, label = ctx.saved_tensors
        g = ctx.grad(y, label) * ctx.grad_scale
        return g.to(y.dtype), None, None, None, None


def _as_data(t: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return t.reshape(y.shape) if t.numel() == y.numel() else t


def _identity(x):
    return x.clone()


def _output_layer(forward, grad, grad_scale):
    def fn(data, label):
        return _OutputLayer.apply(data, label, forward, grad,
                                  float(grad_scale))
    return fn


def linear_regression_maker(grad_scale=1.0):
    return _output_layer(_identity, lambda y, t: y - _as_data(t, y),
                         grad_scale)


def mae_regression_maker(grad_scale=1.0):
    return _output_layer(_identity,
                         lambda y, t: torch.sign(y - _as_data(t, y)),
                         grad_scale)


def logistic_regression_maker(grad_scale=1.0):
    return _output_layer(torch.sigmoid, lambda y, t: y - _as_data(t, y),
                         grad_scale)


def svm_output_maker(margin=1.0, regularization_coefficient=1.0,
                     use_linear=False):
    """L2-SVM by default, L1 (hinge) with ``use_linear``
    (``svm_output-inl.h``), on ``t`` the ±1 one-vs-rest label."""
    def grad(y, label):
        classes = torch.arange(y.shape[1], device=y.device)
        t = 2.0 * (label.long()[:, None] == classes).to(y.dtype) - 1.0
        viol = margin - t * y
        active = (viol > 0).to(y.dtype)
        if use_linear:
            return -regularization_coefficient * t * active
        return -2.0 * regularization_coefficient * t * viol * active
    return _output_layer(_identity, grad, 1.0)


class _MakeLoss(torch.autograd.Function):
    """The identity forward; the backward is ``grad_scale`` (normalised)
    whatever the head gradient."""

    @staticmethod
    def forward(ctx, x, grad_scale, valid_thresh, normalization):
        scale = torch.full((), grad_scale, dtype=x.dtype, device=x.device)
        if normalization == "batch":
            scale = scale / x.shape[0]
        elif normalization == "valid":
            valid = (x > valid_thresh).to(x.dtype).sum()
            scale = scale / torch.clamp(valid, min=1.0)
        ctx.save_for_backward(scale)
        ctx.shape = x.shape
        return x.clone()

    @staticmethod
    def backward(ctx, _head):
        scale, = ctx.saved_tensors
        return scale.expand(ctx.shape).clone(), None, None, None


def make_loss_maker(grad_scale=1.0, valid_thresh=0.0, normalization="null"):
    if normalization not in ("null", "batch", "valid"):
        raise MXNetError(f"MakeLoss: normalization {normalization!r} not "
                         f"in ('null', 'batch', 'valid')")

    def fn(x):
        return _MakeLoss.apply(x, float(grad_scale), float(valid_thresh),
                               normalization)
    return fn


def softmax_activation_maker(mode="instance"):
    def fn(x):
        if mode == "channel":
            return torch.softmax(x, dim=1)
        return torch.softmax(x.reshape(x.shape[0], -1),
                             dim=-1).reshape(x.shape)
    return fn


def _heads_of(x: torch.Tensor, heads: int, parts: int):
    """``(L, B, H * parts * D)`` as ``parts`` tensors ``(B * H, L, D)``."""
    L, B, E = x.shape
    d = E // (parts * heads)
    y = x.reshape(L, B, heads, parts, d)
    return [y[:, :, :, i].permute(1, 2, 0, 3).reshape(B * heads, L, d)
            for i in range(parts)]


def _merge_heads(out: torch.Tensor, heads: int, lq: int, b: int):
    d = out.shape[-1]
    return out.reshape(b, heads, lq, d).permute(2, 0, 1, 3) \
        .reshape(lq, b, heads * d)


def selfatt_qk_maker(heads=1):
    def fn(qkv):
        q, k, _ = _heads_of(qkv, heads, 3)
        scale = 1.0 / float(q.shape[-1]) ** 0.5
        return torch.bmm(q * scale, k.transpose(1, 2))
    return fn


def selfatt_valatt_maker(heads=1):
    def fn(qkv, att):
        _, _, v = _heads_of(qkv, heads, 3)
        return _merge_heads(torch.bmm(att, v), heads, qkv.shape[0],
                            qkv.shape[1])
    return fn


def encdec_qk_maker(heads=1):
    def fn(q_proj, kv):
        q, = _heads_of(q_proj, heads, 1)
        k, _ = _heads_of(kv, heads, 2)
        scale = 1.0 / float(q.shape[-1]) ** 0.5
        return torch.bmm(q * scale, k.transpose(1, 2))
    return fn


def encdec_valatt_maker(heads=1):
    def fn(kv, att):
        _, v = _heads_of(kv, heads, 2)
        return _merge_heads(torch.bmm(att, v), heads, att.shape[1],
                            kv.shape[1])
    return fn


def _register():
    register_op("all_finite", all_finite_maker)
    register_op("multi_all_finite", multi_all_finite_maker)
    register_op("softmax_cross_entropy", softmax_cross_entropy_maker)
    register_op("LinearRegressionOutput", linear_regression_maker,
                aliases=("linear_regression_output",))
    register_op("MAERegressionOutput", mae_regression_maker,
                aliases=("mae_regression_output",))
    register_op("LogisticRegressionOutput", logistic_regression_maker,
                aliases=("logistic_regression_output",))
    register_op("SVMOutput", svm_output_maker, aliases=("svm_output",))
    register_op("MakeLoss", make_loss_maker, aliases=("make_loss",))
    register_op("SoftmaxActivation", softmax_activation_maker,
                aliases=("softmax_activation",))
    register_op("_contrib_interleaved_matmul_selfatt_qk", selfatt_qk_maker,
                aliases=("interleaved_matmul_selfatt_qk",))
    register_op("_contrib_interleaved_matmul_selfatt_valatt",
                selfatt_valatt_maker,
                aliases=("interleaved_matmul_selfatt_valatt",))
    register_op("_contrib_interleaved_matmul_encdec_qk", encdec_qk_maker,
                aliases=("interleaved_matmul_encdec_qk",))
    register_op("_contrib_interleaved_matmul_encdec_valatt",
                encdec_valatt_maker,
                aliases=("interleaved_matmul_encdec_valatt",))


_register()


# ---- the rest of the file ---------------------------------------------

def add_n_maker(num_args=None):
    def fn(*xs):
        out = xs[0]
        for x in xs[1:]:
            out = out + x
        return out
    return fn


class _KLSparseReg(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rho, penalty):
        ctx.save_for_backward(x)
        ctx.rho, ctx.penalty = rho, penalty
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        rho = ctx.rho
        rho_hat = torch.sigmoid(x).mean(dim=0, keepdim=True)
        kl = ctx.penalty * (-rho / rho_hat + (1 - rho) / (1 - rho_hat))
        return g + kl * torch.ones_like(x), None, None


def kl_sparse_reg_maker(sparseness_target=0.1, penalty=0.001, momentum=0.9):
    return lambda x: _KLSparseReg.apply(x, float(sparseness_target),
                                        float(penalty))


def _pdf_bcast(p, sample):
    while p.dim() < sample.dim():
        p = p[..., None]
    return p


_LOG_2PI = 0.5 * np.log(2 * np.pi)

_PDFS = {
    "uniform": lambda x, low, high: torch.where(
        (x >= low) & (x <= high), -torch.log(high - low),
        torch.full_like(x, -math.inf)),
    "normal": lambda x, mu, sigma: (-0.5 * ((x - mu) / sigma) ** 2
                                    - torch.log(sigma) - _LOG_2PI),
    "gamma": lambda x, alpha, beta: ((alpha - 1) * torch.log(x) - x / beta
                                     - torch.lgamma(alpha)
                                     - alpha * torch.log(beta)),
    "exponential": lambda x, lam: torch.log(lam) - lam * x,
    "poisson": lambda x, lam: (x * torch.log(lam) - lam
                               - torch.lgamma(x + 1.0)),
    "negative_binomial": lambda x, k, p: (
        torch.lgamma(x + k) - torch.lgamma(x + 1.0) - torch.lgamma(k)
        + k * torch.log(p) + x * torch.log1p(-p)),
    "generalized_negative_binomial": lambda x, mu, alpha: (
        torch.lgamma(x + 1.0 / alpha) - torch.lgamma(x + 1.0)
        - torch.lgamma(1.0 / alpha) - (1.0 / alpha) * torch.log1p(alpha * mu)
        + x * (torch.log(alpha) + torch.log(mu)
               - torch.log1p(alpha * mu))),
}


def _pdf_maker(logpdf):
    def maker(is_log=False):
        def fn(sample, *params):
            lp = logpdf(sample, *[_pdf_bcast(p, sample) for p in params])
            return lp if is_log else torch.exp(lp)
        return fn
    return maker


def dirichlet_maker(is_log=False):
    def fn(sample, alpha):
        a = alpha[..., None, :]
        lp = (((a - 1) * torch.log(sample)).sum(-1)
              + torch.lgamma(a.sum(-1)) - torch.lgamma(a).sum(-1))
        return lp if is_log else torch.exp(lp)
    return fn


def fft_maker(compute_size=128):
    def fn(x):
        c = torch.fft.fft(x.float(), dim=-1)
        return torch.stack([c.real, c.imag], dim=-1).reshape(
            x.shape[:-1] + (2 * x.shape[-1],))
    return fn


def ifft_maker(compute_size=128):
    def fn(x):
        d = x.shape[-1] // 2
        pairs = x.float().reshape(x.shape[:-1] + (d, 2))
        c = torch.complex(pairs[..., 0], pairs[..., 1])
        return torch.fft.ifft(c, dim=-1).real * d
    return fn


def boolean_mask_maker(axis=0):
    def fn(data, index):
        host_read("_contrib_boolean_mask", index)
        keep = torch.nonzero(index.reshape(-1) != 0).reshape(-1)
        return data.index_select(int(axis), keep.to(data.device))
    return fn


def arange_like_maker(start=0.0, step=1.0, repeat=1, axis=None):
    def fn(data):
        n = data.numel() if axis is None else data.shape[axis]
        idx = torch.div(torch.arange(n, device=data.device), int(repeat),
                        rounding_mode="floor")
        vals = (start + step * idx).to(data.dtype)
        if axis is None:
            return vals.reshape(data.shape)
        shape = [1] * data.dim()
        shape[axis] = n
        return vals.reshape(shape).expand(data.shape).contiguous()
    return fn


def quadratic_maker(a=0.0, b=0.0, c=0.0):
    return lambda x: a * x * x + b * x + c


class _GradScale(torch.autograd.Function):
    """The identity; the gradient times ``scale`` (``gradientmultiplier``;
    1 for the straight-through estimators, whose forward is ``fwd``)."""

    @staticmethod
    def forward(ctx, x, scale, fwd):
        ctx.scale = scale
        return fwd(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale if ctx.scale != 1.0 else g, None, None


def gradmult_maker(scalar=1.0):
    return lambda x: _GradScale.apply(x, float(scalar), torch.clone)


def _round_half_away(x):
    return torch.where(x >= 0, torch.floor(x + 0.5), torch.ceil(x - 0.5))


def crop_maker(num_args=1, offset=(0, 0), h_w=(0, 0), center_crop=False):
    offset, h_w = tuple(offset), tuple(h_w)

    def fn(data, *crop_like):
        th, tw = h_w
        if crop_like:
            th, tw = crop_like[0].shape[2], crop_like[0].shape[3]
        H, W = data.shape[2], data.shape[3]
        y0, x0 = ((H - th) // 2, (W - tw) // 2) if center_crop else offset
        return data[:, :, y0:y0 + th, x0:x0 + tw].contiguous()
    return fn


def _conv_args(kernel, stride, dilate, pad):
    kernel = tuple(int(k) for k in kernel)
    n = len(kernel)
    stride = tuple(stride) if stride else (1,) * n
    dilate = tuple(dilate) if dilate else (1,) * n
    pad = tuple(pad) if pad else (0,) * n
    return kernel, stride, dilate, pad


def _patch_slices(spatial, kernel, stride, dilate, pad):
    """The output's spatial size and, for each kernel offset (row-major),
    the strided slices of the padded input it reads."""
    outs = [(spatial[i] + 2 * pad[i] - dilate[i] * (k - 1) - 1) // stride[i]
            + 1 for i, k in enumerate(kernel)]
    slices = []
    for off in np.ndindex(*kernel):
        slices.append(tuple(
            slice(o * dilate[i], o * dilate[i] + stride[i] * (outs[i] - 1)
                  + 1, stride[i]) for i, o in enumerate(off)))
    return outs, slices


def _pad_spatial(pad):
    return [p for q in reversed(pad) for p in (q, q)]


def im2col_maker(kernel=(3, 3), stride=None, dilate=None, pad=None):
    kernel, stride, dilate, pad = _conv_args(kernel, stride, dilate, pad)

    def fn(data):
        n, c = data.shape[:2]
        outs, slices = _patch_slices(data.shape[2:], kernel, stride, dilate,
                                     pad)
        xp = F.pad(data, _pad_spatial(pad)) if any(pad) else data
        cols = torch.stack([xp[(Ellipsis,) + s] for s in slices], dim=2)
        return cols.reshape(n, c * len(slices), math.prod(outs))
    return fn


def col2im_maker(output_size=None, kernel=(3, 3), stride=None, dilate=None,
                 pad=None):
    kernel, stride, dilate, pad = _conv_args(kernel, stride, dilate, pad)
    size = tuple(int(s) for s in output_size)

    def fn(col):
        outs, slices = _patch_slices(size, kernel, stride, dilate, pad)
        n, k = col.shape[0], len(slices)
        c = col.shape[1] // k
        cols = col.reshape(n, c, k, *outs)
        padded = [s + 2 * p for s, p in zip(size, pad)]
        out = col.new_zeros((n, c, *padded))
        for j, s in enumerate(slices):
            out[(Ellipsis,) + s] += cols[:, :, j]
        crop = tuple(slice(p, p + sz) for p, sz in zip(pad, size))
        return out[(Ellipsis,) + crop].contiguous()
    return fn


def histogram_maker(bin_cnt=None, range=None):
    def fn(data, *maybe_bins):
        flat = data.reshape(-1)
        dt = flat.dtype if flat.is_floating_point() else torch.float32
        flat = flat.to(dt)
        if maybe_bins:
            edges = maybe_bins[0].to(dt)
        else:
            if range is None:
                host_read("histogram", data)
                lo, hi = flat.min().item(), flat.max().item()
            else:
                lo, hi = (float(v) for v in range)
            if lo == hi:
                lo, hi = lo - 0.5, hi + 0.5
            edges = jnp_linspace(lo, hi, int(bin_cnt or 10) + 1, dtype=dt,
                                 device=data.device)
        if flat.device.type == "meta":
            return torch.empty(edges.numel() - 1, dtype=torch.int32,
                               device="meta"), edges
        idx = torch.searchsorted(edges, flat, right=True)
        idx = torch.where(flat == edges[-1], edges.numel() - 1, idx)
        counts = torch.bincount(idx, minlength=edges.numel() + 1)
        return counts[1:edges.numel()].to(torch.int32), edges
    return fn


def choose_element_0index_maker():
    return lambda lhs, rhs: lhs.gather(1, rhs.long()[:, None])[:, 0]


def fill_element_0index_maker():
    def fn(lhs, mhs, rhs):
        rows = torch.arange(lhs.shape[0], device=lhs.device)
        return lhs.index_put((rows, rhs.long()), mhs)
    return fn


def split_v2_maker(indices=(), axis=0, squeeze_axis=False, sections=0):
    idx = normalize_split_indices(indices)

    def fn(data):
        if sections:
            n = data.shape[axis]
            if n % int(sections):
                raise MXNetError(f"split_v2: axis {axis} of size {n} does "
                                 f"not split into {sections} equal parts")
            parts = torch.split(data, n // int(sections), dim=axis)
        else:
            parts = torch.tensor_split(data, [int(i) for i in idx],
                                       dim=axis)
        parts = [(p.squeeze(axis) if squeeze_axis else p).clone(
            memory_format=torch.contiguous_format) for p in parts]
        return parts[0] if len(parts) == 1 else tuple(parts)
    return fn


def hawkesll_maker():
    """The log-likelihood of a marked Hawkes process with exponential
    kernels (``hawkes_ll.cc``): the JAX package's recursion over the
    events, ``(loglik (N,), final decayed states (N, K))``."""
    def fn(lda, alpha, beta, state, lags, marks, valid_length, max_time):
        n, steps = lags.shape
        k = lda.shape[1]
        marks_i = marks.long()
        vl = valid_length.long()
        r, t = state, lags.new_zeros(n)
        ll = lags.new_zeros(n)
        prev = torch.full((n,), -1, dtype=torch.long, device=lags.device)
        times = []
        rows = torch.arange(n, device=lags.device)
        for i in range(steps):
            lag, mark = lags[:, i], marks_i[:, i]
            decay = torch.exp(-beta * lag[:, None])
            onehot = F.one_hot(prev.clamp(min=0), k).to(r.dtype) * \
                (prev >= 0)[:, None].to(r.dtype)
            r_new = decay * (r + onehot)
            t_new = t + lag
            lam = lda[rows, mark] + alpha[mark] * beta[mark] * \
                r_new[rows, mark]
            valid = i < vl
            ll = ll + torch.where(valid, torch.log(lam), torch.zeros_like(lam))
            r = torch.where(valid[:, None], r_new, r)
            t = torch.where(valid, t_new, t)
            prev = torch.where(valid, mark, prev)
            times.append(t_new)
        times = torch.stack(times, dim=1)
        comp_bg = lda.sum(1) * max_time
        comp_init = (alpha * state * (1.0 - torch.exp(
            -beta * max_time[:, None]))).sum(1)
        ev_valid = torch.arange(steps, device=lags.device)[None] < vl[:, None]
        contrib = alpha[marks_i] * (1.0 - torch.exp(
            -beta[marks_i] * torch.clamp(max_time[:, None] - times, min=0.0)))
        comp_ex = torch.where(ev_valid, contrib,
                              torch.zeros_like(contrib)).sum(1)
        onehot = F.one_hot(prev.clamp(min=0), k).to(r.dtype) * \
            (prev >= 0)[:, None].to(r.dtype)
        r_final = torch.exp(-beta * torch.clamp(max_time - t, min=0.0)
                            [:, None]) * (r + onehot)
        return ll - comp_bg - comp_init - comp_ex, r_final
    return fn


def square_sum_maker(axis=None, keepdims=False, exclude=False):
    def fn(x):
        ax = tuple(axis) if isinstance(axis, (list, tuple)) else \
            (axis,) if axis is not None else None
        if ax is not None and exclude:
            norm = {a % x.dim() for a in ax}
            ax = tuple(i for i in range(x.dim()) if i not in norm)
        if ax is None:
            return int32_result(x, x.square().sum())
        return int32_result(x, x.square().sum(dim=ax, keepdim=keepdims))
    return fn


def _logical(op):
    def maker():
        return lambda lhs, rhs: op(lhs != 0, rhs != 0).to(torch.float32)
    return maker


def _on(ctx, make):
    def fn():
        return make(as_device(ctx))
    return fn


def zeros_maker(shape=(), ctx=None, dtype="float32"):
    shp, dt = tuple(int(s) for s in shape), torch_dtype(dtype)
    return _on(ctx, lambda dev: torch.zeros(shp, dtype=dt, device=dev))


def ones_maker(shape=(), ctx=None, dtype="float32"):
    shp, dt = tuple(int(s) for s in shape), torch_dtype(dtype)
    return _on(ctx, lambda dev: torch.ones(shp, dtype=dt, device=dev))


def full_maker(shape=(), ctx=None, dtype="float32", value=0.0):
    shp, dt = tuple(int(s) for s in shape), torch_dtype(dtype)
    return _on(ctx, lambda dev: torch.full(shp, value, dtype=dt, device=dev))


def arange_maker(start=0.0, stop=None, step=1.0, repeat=1,
                 infer_range=False, ctx=None, dtype="float32"):
    dt = torch_dtype(dtype)
    lo, hi = (0, start) if stop is None else (start, stop)

    def make(dev):
        out = torch.arange(lo, hi, step, dtype=dt, device=dev)
        return out.repeat_interleave(int(repeat)) if repeat > 1 else out
    return _on(ctx, make)


def linspace_maker(start=0.0, stop=1.0, num=50, endpoint=True, ctx=None,
                   dtype="float32"):
    dt = torch_dtype(dtype)
    return _on(ctx, lambda dev: jnp_linspace(start, stop, num, endpoint,
                                             dtype=dt, device=dev))


def eye_maker(N=0, M=0, k=0, ctx=None, dtype="float32"):
    n, m, dt = int(N), int(M) if M else int(N), torch_dtype(dtype)

    def make(dev):
        rows = torch.arange(n, device=dev)[:, None]
        return (rows + int(k) == torch.arange(m, device=dev)[None]).to(dt)
    return _on(ctx, make)


def _assign_slices(begin, end, step, ndim):
    idx = []
    for i in range(ndim):
        b = begin[i] if i < len(begin) else None
        e = end[i] if i < len(end) else None
        st = step[i] if i < len(step) else None
        idx.append(slice(None if b is None else int(b),
                         None if e is None else int(e),
                         None if st is None else int(st)))
    return tuple(idx)


def _set_slices(lhs, idx, rhs):
    """``lhs`` with ``rhs`` written at the slices ``idx`` (steps may be
    negative), out of place: an ``index_put`` over each axis's range."""
    ranges = [torch.arange(*s.indices(n), device=lhs.device)
              for s, n in zip(idx, lhs.shape)]
    index = tuple(r.reshape([-1 if i == d else 1 for i in range(len(idx))])
                  for d, r in enumerate(ranges))
    return lhs.index_put(index, torch.broadcast_to(
        rhs.to(lhs.dtype), [len(r) for r in ranges]))


def slice_assign_maker(begin=(), end=(), step=()):
    def fn(lhs, rhs):
        return _set_slices(lhs, _assign_slices(begin, end, step, lhs.dim()),
                           rhs)
    return fn


def slice_assign_scalar_maker(begin=(), end=(), step=(), scalar=0.0):
    def fn(lhs):
        val = torch.tensor(scalar, dtype=lhs.dtype, device=lhs.device)
        return _set_slices(lhs, _assign_slices(begin, end, step, lhs.dim()),
                           val)
    return fn


def onehot_encode_maker():
    def fn(indices, out):
        return F.one_hot(indices.long(), out.shape[1]).to(out.dtype)
    return fn


def scatter_set_nd_maker(shape=None):
    def fn(lhs, rhs, indices):
        out = lhs.clone()
        out[tuple(indices.long())] = rhs
        return out
    return fn


def rnn_param_concat_maker(dim=0, num_args=1):
    def fn(*parts):
        return torch.cat([p.reshape(-1) if dim == 0 and p.dim() > 1 else p
                          for p in parts], dim=dim)
    return fn


def _register_rest():
    register_op("add_n", add_n_maker,
                aliases=("ElementWiseSum", "elemwise_sum"))
    register_op("IdentityAttachKLSparseReg", kl_sparse_reg_maker)
    for name, logpdf in _PDFS.items():
        register_op(f"_random_pdf_{name}", _pdf_maker(logpdf),
                    aliases=(f"pdf_{name}",))
    register_op("_random_pdf_dirichlet", dirichlet_maker,
                aliases=("pdf_dirichlet",))
    register_op("_contrib_fft", fft_maker, aliases=("fft",))
    register_op("_contrib_ifft", ifft_maker, aliases=("ifft",))
    register_op("_contrib_boolean_mask", boolean_mask_maker,
                aliases=("boolean_mask",))
    register_op("_contrib_arange_like", arange_like_maker,
                aliases=("arange_like",), differentiable=False)
    register_op("_contrib_quadratic", quadratic_maker,
                aliases=("quadratic",))
    register_op("_contrib_gradientmultiplier", gradmult_maker,
                aliases=("gradientmultiplier",))
    register_op("Crop", crop_maker, aliases=("crop_2d",))
    register_op("im2col", im2col_maker)
    register_op("col2im", col2im_maker)
    register_op("histogram", histogram_maker, differentiable=False)
    register_op("choose_element_0index", choose_element_0index_maker)
    register_op("fill_element_0index", fill_element_0index_maker)
    register_op("split_v2", split_v2_maker, aliases=("_split_v2",))
    register_op("_contrib_hawkesll", hawkesll_maker, aliases=("hawkesll",))
    register_op("_square_sum", square_sum_maker, aliases=("square_sum",))
    simple_op("_hypot", torch.hypot, aliases=("hypot",))
    simple_op("_hypot_scalar", lambda x, s: torch.hypot(x, s.to(x.dtype)))
    for name, op in (("and", torch.logical_and), ("or", torch.logical_or),
                     ("xor", torch.logical_xor)):
        register_op(f"_logical_{name}", _logical(op), differentiable=False)
    for name, maker in (("_zeros", zeros_maker), ("_ones", ones_maker),
                        ("_full", full_maker), ("_arange", arange_maker),
                        ("_linspace", linspace_maker), ("_eye", eye_maker)):
        register_op(name, maker, differentiable=False)
    register_op("_slice_assign", slice_assign_maker,
                aliases=("_crop_assign",))
    register_op("_slice_assign_scalar", slice_assign_scalar_maker,
                aliases=("_crop_assign_scalar",))
    register_op("_onehot_encode", onehot_encode_maker, differentiable=False)
    register_op("_scatter_set_nd", scatter_set_nd_maker,
                differentiable=False)
    simple_op("_copyto", torch.clone)
    register_op("_set_value", lambda src=0.0: (
        lambda x: torch.full_like(x, src)), differentiable=False)
    simple_op("_identity_with_attr_like_rhs", lambda lhs, rhs: lhs.clone())
    register_op("_rnn_param_concat", rnn_param_concat_maker)
    register_op("round_ste", lambda: (
        lambda x: _GradScale.apply(x, 1.0, _round_half_away)),
        aliases=("_contrib_round_ste",))
    register_op("sign_ste", lambda: (
        lambda x: _GradScale.apply(x, 1.0, torch.sign)),
        aliases=("_contrib_sign_ste",))


_register_rest()
