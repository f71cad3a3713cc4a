"""The long tail of the registry: special functions, the activation tail,
numpy's tail, the shape tail, masked softmax and ``lars_update``.

Counterpart of ``mxnet_tpu/ndarray/ops_tail.py``: the special functions
(:25-61: ``erfc``, ``bessel_i0/i1/i0e/i1e``, ``erfcinv``, ``polygamma``,
``gammainc``, ``gammaincc``, ``zeta``, ``gelu``) and the activations
``log_sigmoid``, ``mish``, ``silu`` (alias ``swish``) and
``hard_swish``; the predicates ``isnan/isinf/isfinite/isposinf/
isneginf``, the binaries ``copysign``, ``gcd``, ``lcm``, ``heaviside``,
``ldexp``, ``logaddexp`` and ``interp``, and ``nan_to_num``, ``cumprod``,
``logsumexp``, ``bincount``, ``digitize``, ``searchsorted``,
``ediff1d`` and ``trapz`` (:64-136); ``einsum``, ``roll``, ``rot90``,
``tensordot``, ``vander``, ``meshgrid`` and ``kron`` (:139-174);
``masked_softmax``/``masked_log_softmax`` (:177-199) and
``lars_update`` (:204-223).  The JAX package computes them in XLA
outside any Pallas kernel; here they are torch code, with its
conventions:

- the predicates answer 0/1 in the input's dtype, not bool; ``gcd``,
  ``lcm``, ``digitize``, ``searchsorted`` and ``bincount`` take no
  gradient (``differentiable=False``), and the three index ops answer
  int32, as the JAX package's without 64-bit types;
- ``erfcinv`` is ``erfinv(1 - x)``, the JAX package's reflection, and
  ``ldexp`` is ``x * 2 ** e`` with a float exponent (the gradient flows
  through ``e``); ``heaviside`` is a ``where`` (its gradient reaches the
  second input where the first is 0), and ``interp`` is ``jnp.interp``'s
  formula (constant beyond the ends);
- ``zeta``'s gradient in ``x`` and ``gammainc``/``gammaincc``'s in ``a``,
  which torch does not have, are ``torch.autograd.Function``s computed in
  float64: ``d/dx zeta(x, q)`` by the derivative of the Euler-Maclaurin
  sum (nine terms and six Bernoulli corrections), ``d/da P(a, x)`` by the
  series ``sum_n t_n (log x - digamma(a + n + 1))``, ``t_n = x^(a+n)
  e^-x / Gamma(a + n + 1)``, over 256 terms on the card, which holds to
  fp32 for ``x`` up to about 100 (on the CPU over the terms the largest
  ``x`` needs);
- ``bincount`` reads the largest value to the host (its output length),
  as the JAX op does eagerly: see ``register.host_read``;
- ``meshgrid`` returns one array per input; ``masked_softmax`` fills the
  masked logits with the dtype's lowest value and divides by the sum
  floored at the smallest normal, as the JAX op does.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .register import host_read, register_op, simple_op
from .ops_reduce import SMALL_INT

_F64 = torch.float64


# ---- special functions ------------------------------------------------

# B_2j / (2j)! for j = 1..6 (Euler-Maclaurin corrections)
_EM_COEF = (1 / 12, -1 / 720, 1 / 30240, -1 / 1209600, 1 / 47900160,
            -691 / 1307674368000)
_EM_TERMS = 9


def _zeta_dx(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``d/dx zeta(x, q)`` in float64: the derivative in ``x`` of the
    Euler-Maclaurin sum of ``sum_k (k + q)^-x``."""
    x, q = torch.broadcast_tensors(x.to(_F64), q.to(_F64))
    out = torch.zeros_like(x)
    for k in range(_EM_TERMS):
        s = q + k
        out = out - torch.log(s) * s.pow(-x)
    u = q + _EM_TERMS
    lu = torch.log(u)
    xm1 = x - 1.0
    tail = u.pow(1.0 - x) / xm1
    out = out - lu * tail - tail / xm1 - lu * u.pow(-x) / 2.0
    rising = x.clone()                  # x (x + 1) ... (x + 2j - 2)
    inv_sum = 1.0 / x
    for j, c in enumerate(_EM_COEF, start=1):
        if j > 1:
            for i in (2 * j - 3, 2 * j - 2):
                rising = rising * (x + i)
                inv_sum = inv_sum + 1.0 / (x + i)
        term = c * rising * u.pow(-x - 2 * j + 1)
        out = out + term * (inv_sum - lu)
    return out


class _Zeta(torch.autograd.Function):
    """Hurwitz ``zeta(x, q)``; gradients ``_zeta_dx`` and
    ``-x zeta(x + 1, q)``."""

    @staticmethod
    def forward(ctx, x, q):
        ctx.save_for_backward(x, q)
        return torch.special.zeta(x, q)

    @staticmethod
    def backward(ctx, g):
        x, q = ctx.saved_tensors
        gx = gq = None
        if ctx.needs_input_grad[0]:
            gx = g * _zeta_dx(x, q).to(g.dtype)
        if ctx.needs_input_grad[1]:
            gq = g * (-x * torch.special.zeta(x + 1.0, q))
        return _unbroadcast(gx, x), _unbroadcast(gq, q)


_GAMMA_TERMS = 256


def _series_terms(x: torch.Tensor) -> int:
    """Terms of ``_gammainc_da``'s series: ``_GAMMA_TERMS`` on the card
    (no host read, so a CUDA graph can capture it); on the CPU the ones
    the largest ``x`` needs, ``x + 12 sqrt(x) + 10`` (the Poisson weights
    beyond lie under 1e-30)."""
    if x.device.type != "cpu" or not x.numel():
        return _GAMMA_TERMS
    top = max(float(x.max()), 0.0)
    return min(_GAMMA_TERMS, int(math.ceil(top + 12 * math.sqrt(top) + 10)))


def _gammainc_da(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``d/da P(a, x)`` (regularized lower incomplete gamma) in float64,
    by the series ``P = sum_n t_n``, ``t_n = x^(a+n) e^-x /
    Gamma(a+n+1)``: ``dP/da = sum_n t_n (log x - digamma(a + n + 1))``;
    0 where ``x`` is 0."""
    a, x = torch.broadcast_tensors(a.to(_F64), x.to(_F64))
    pos = x > 0
    xs = torch.where(pos, x, torch.ones_like(x))
    lx = torch.log(xs)
    t = torch.exp(a * lx - xs - torch.lgamma(a + 1.0))
    psi = torch.digamma(a + 1.0)
    out = t * (lx - psi)
    for n in range(1, _series_terms(x)):
        an = a + n
        t = t * xs / an
        psi = psi + 1.0 / an
        out = out + t * (lx - psi)
    return torch.where(pos, out, torch.zeros_like(out))


class _GammaInc(torch.autograd.Function):
    """``gammainc(a, x)`` (``upper``: ``gammaincc``), differentiable in
    both inputs."""

    @staticmethod
    def forward(ctx, a, x, upper):
        ctx.save_for_backward(a, x)
        ctx.upper = upper
        return (torch.special.gammaincc if upper
                else torch.special.gammainc)(a, x)

    @staticmethod
    def backward(ctx, g):
        a, x = ctx.saved_tensors
        sign = -1.0 if ctx.upper else 1.0
        ga = gx = None
        if ctx.needs_input_grad[0]:
            ga = g * (sign * _gammainc_da(a, x)).to(g.dtype)
        if ctx.needs_input_grad[1]:
            dens = torch.exp(-x + (a - 1.0) * torch.log(x)
                             - torch.lgamma(a))
            gx = g * (sign * dens)
        return _unbroadcast(ga, a), _unbroadcast(gx, x), None


def _unbroadcast(g, like: torch.Tensor):
    """``g`` summed down to ``like``'s shape (broadcast inputs)."""
    if g is None or g.shape == like.shape:
        return g
    extra = g.dim() - like.dim()
    g = g.sum(dim=tuple(range(extra))) if extra else g
    dims = tuple(i for i, n in enumerate(like.shape) if n == 1
                 and g.shape[i] != 1)
    return g.sum(dim=dims, keepdim=True) if dims else g


def _register_special():
    unary = {
        "erfc": torch.erfc,
        "bessel_i0": torch.special.i0,
        "bessel_i1": torch.special.i1,
        "bessel_i0e": torch.special.i0e,
        "bessel_i1e": torch.special.i1e,
        "log_sigmoid": F.logsigmoid,
        "mish": lambda x: x * torch.tanh(F.softplus(x)),
        "hard_swish": lambda x: x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0,
        "erfcinv": lambda x: torch.erfinv(1.0 - x),
    }
    for name, fn in unary.items():
        simple_op(name, fn)
    simple_op("silu", F.silu, aliases=("swish",))
    register_op("polygamma", lambda n=0: (
        lambda x: torch.special.polygamma(int(n), x)))
    simple_op("gammainc", lambda a, x: _GammaInc.apply(a, x, False))
    simple_op("gammaincc", lambda a, x: _GammaInc.apply(a, x, True))
    simple_op("zeta", _Zeta.apply)

    def gelu_maker(approximation="erf"):
        approx = "tanh" if approximation == "tanh" else "none"
        return lambda x: F.gelu(x, approximate=approx)
    register_op("gelu", gelu_maker)


# ---- numpy's tail -----------------------------------------------------

def _pred(fn):
    return lambda x: fn(x).to(x.dtype)


def _heaviside(x1, x2):
    zero, one = torch.zeros_like(x1), torch.ones_like(x1)
    return torch.where(x1 < 0, zero, torch.where(x1 > 0, one, x2 + zero))


def _interp(x, xp, fp):
    """``jnp.interp`` (constant ``fp[0]``/``fp[-1]`` beyond the ends)."""
    i = torch.searchsorted(xp, x, right=True).clamp(1, xp.numel() - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = torch.finfo(xp.dtype).eps
    dx0 = dx.abs() <= eps * torch.finfo(xp.dtype).eps
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def nan_to_num_maker(nan=0.0, posinf=None, neginf=None, copy=True):
    return lambda x: torch.nan_to_num(x, nan=nan, posinf=posinf,
                                      neginf=neginf)


def cumprod_maker(axis=None, dtype=None):
    def fn(x):
        if dtype is not None:
            from ..base import torch_dtype
            x = x.to(torch_dtype(dtype))
        keep = x.dtype if x.dtype in SMALL_INT else None
        if axis is None:
            return torch.cumprod(x.reshape(-1), 0, dtype=keep)
        return torch.cumprod(x, int(axis), dtype=keep)
    return fn


def logsumexp_maker(axis=None, keepdims=False):
    def fn(x):
        dims = tuple(range(x.dim())) if axis is None else \
            (axis,) if isinstance(axis, int) else tuple(axis)
        return torch.logsumexp(x, dim=dims, keepdim=keepdims)
    return fn


def bincount_maker(minlength=0):
    def fn(x, *weights):
        host_read("bincount", x)
        n = max(int(minlength), int(x.max()) + 1 if x.numel() else 0)
        w = weights[0] if weights else None
        out = torch.bincount(x.reshape(-1).long(),
                             weights=None if w is None else w.reshape(-1),
                             minlength=n)
        return out.to(torch.int32) if w is None else out.to(w.dtype)
    return fn


def digitize_maker(right=False):
    def fn(x, bins):
        if bins.numel() == 0:
            return torch.zeros_like(x, dtype=torch.int32)
        up = torch.searchsorted(bins, x, right=not right)
        down = bins.numel() - torch.searchsorted(bins.flip(0), x,
                                                 right=not right)
        return torch.where(bins[-1] >= bins[0], up, down).to(torch.int32)
    return fn


def searchsorted_maker(side="left"):
    return lambda a, v: torch.searchsorted(
        a, v, right=side == "right").to(torch.int32)


def trapz_maker(dx=1.0, axis=-1):
    def fn(y, *xp):
        if xp:
            return torch.trapezoid(y, x=xp[0], dim=axis)
        return torch.trapezoid(y, dx=dx, dim=axis)
    return fn


def _register_np_tail():
    for name, fn in {"isnan": torch.isnan, "isinf": torch.isinf,
                     "isfinite": torch.isfinite,
                     "isposinf": torch.isposinf,
                     "isneginf": torch.isneginf}.items():
        simple_op(name, _pred(fn), differentiable=False)
    register_op("nan_to_num", nan_to_num_maker)
    simple_op("logaddexp", torch.logaddexp)
    simple_op("heaviside", _heaviside)
    simple_op("copysign", torch.copysign)
    simple_op("ldexp", lambda x, e: x * 2.0 ** e)
    simple_op("lcm", torch.lcm, differentiable=False)
    simple_op("gcd", torch.gcd, differentiable=False)
    register_op("cumprod", cumprod_maker)
    register_op("logsumexp", logsumexp_maker)
    register_op("bincount", bincount_maker, differentiable=False)
    register_op("digitize", digitize_maker, differentiable=False)
    register_op("searchsorted", searchsorted_maker, differentiable=False)
    simple_op("interp", _interp)
    register_op("ediff1d", lambda: (lambda x: torch.diff(x.reshape(-1))))
    register_op("trapz", trapz_maker)


# ---- the shape tail ---------------------------------------------------

def einsum_maker(subscripts=""):
    if not subscripts:
        raise ValueError("einsum requires a subscripts string")
    return lambda *ops: torch.einsum(subscripts, *ops)


def roll_maker(shift=None, axis=None):
    sh = shift if shift is None or isinstance(shift, int) else tuple(shift)
    ax = axis if axis is None or isinstance(axis, int) else tuple(axis)

    def fn(x):
        if ax is None:
            return torch.roll(x.reshape(-1), sh).reshape(x.shape)
        return torch.roll(x, sh, ax)
    return fn


def rot90_maker(k=1, axes=(0, 1)):
    return lambda x: torch.rot90(x, int(k), tuple(axes)).contiguous()


def tensordot_maker(axes=2):
    ax = axes if isinstance(axes, int) else [list(a) for a in axes]
    return lambda a, b: torch.tensordot(a, b, dims=ax)


def vander_maker(N=None, increasing=False):
    def fn(x):
        v = torch.linalg.vander(x, N=N)
        return v if increasing else v.flip(-1)
    return fn


def meshgrid_maker(indexing="xy", sparse=False):
    def fn(*xs):
        grids = torch.meshgrid(*xs, indexing=indexing)
        if not sparse:
            return tuple(g.contiguous() for g in grids)
        n = len(xs)
        out = []
        for i, x in enumerate(xs):
            shape = [1] * n
            axis = i
            if indexing == "xy" and n >= 2 and i < 2:
                axis = 1 - i
            shape[axis] = x.numel()
            out.append(x.reshape(shape).clone())
        return tuple(out)
    return fn


def _register_shape_tail():
    register_op("einsum", einsum_maker)
    register_op("roll", roll_maker)
    register_op("rot90", rot90_maker)
    simple_op("kron", torch.kron)
    register_op("tensordot", tensordot_maker)
    register_op("vander", vander_maker)
    register_op("meshgrid", meshgrid_maker)


# ---- masked softmax ---------------------------------------------------

def _masked(log: bool):
    def maker(axis=-1, temperature=1.0, normalize=True):
        def fn(x, mask):
            m = mask != 0
            info = torch.finfo(x.dtype)
            neg = torch.full((), info.min, dtype=x.dtype, device=x.device)
            z = torch.where(m, x / temperature, neg)
            z = z - z.amax(dim=axis, keepdim=True)
            e = torch.where(m, torch.exp(z), torch.zeros_like(z))
            if log:
                lse = torch.log(e.sum(dim=axis, keepdim=True))
                return torch.where(m, z - lse, neg)
            return e / torch.clamp(e.sum(dim=axis, keepdim=True),
                                   min=info.tiny)
        return fn
    return maker


# ---- LARS -------------------------------------------------------------

def lars_update_maker(lr, eta=0.001, wd=0.0, rescale_grad=1.0,
                      clip_gradient=-1.0, epsilon=1e-9):
    """One LARS step on one tensor: the gradient rescaled and clipped in
    float32, the trust ratio ``eta * |w| / (|g| + wd * |w| + epsilon)``
    in float32 (1 where either norm is 0; it stays on the device), then a
    plain SGD step at ``trust * lr``, rounded to the weight's dtype.  The
    multi-tensor LARS path is ``multi_lars`` (``ops_optimizer.py``)."""
    def fn(weight, grad):
        w = weight.float()
        g = grad.float() * rescale_grad
        if clip_gradient > 0:
            g = g.clamp(-clip_gradient, clip_gradient)
        wn = w.square().sum().sqrt()
        gn = g.square().sum().sqrt()
        trust = torch.where((wn > 0) & (gn > 0),
                            eta * wn / (gn + wd * wn + epsilon),
                            torch.ones_like(wn))
        return (w - trust * lr * (g + wd * w)).to(weight.dtype)
    return fn


_register_special()
_register_np_tail()
_register_shape_tail()
register_op("masked_softmax", _masked(log=False))
register_op("masked_log_softmax", _masked(log=True))
register_op("lars_update", lars_update_maker)
