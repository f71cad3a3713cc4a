"""Sampling operators: the ``_random_*`` draws with scalar parameters, their
``*_like`` forms, the per-element ``_sample_*`` draws,
``_sample_multinomial`` and ``_shuffle``.

Counterpart of ``mxnet_tpu/ndarray/ops_random.py`` (:43-374).  A
``_random_*`` op has no tensor input: its parameters carry the
distribution, ``shape`` (None is ``(1,)``), ``dtype`` (float32; int32 for
``randint``) and ``ctx`` (the current context if None).  A ``*_like`` op
draws in its input's shape, on its device, in its dtype unless ``dtype``
says otherwise.  A ``_sample_*`` op takes its parameters as tensors,
broadcast together to a shape ``s``, and answers ``s + shape``: one draw
(or a block of ``shape`` draws) for each parameter element.

Every draw takes the generator of its device (``mx.random.generator``),
never torch's default one: draws are reproducible under
``mx.random.seed``, and a hybridized block's captured graph registers
that generator, so each replay draws afresh.  They are not equal to the
JAX package's ``jax.random`` streams.  The distributions are the JAX
package's: gamma with shape ``alpha`` and scale ``beta``; exponential by
its rate ``lam`` (``_random_exponential`` also takes ``scale = 1 / lam``,
as ``nd.random.exponential`` passes it); negative binomial
``NB(k, p) = Poisson(Gamma(k, (1 - p) / p))``; the generalized one with
mean ``mu`` and dispersion ``alpha``, ``NB(1 / alpha, 1 / (1 + alpha
mu))``.  Gamma and Poisson draws are ``torch._standard_gamma`` and
``torch.poisson`` with the generator.  Draws take no gradient, except
``_sample_multinomial(get_prob=True)``'s log-probabilities, whose
gradient in ``p`` is ``1 / p`` at the drawn class (the JAX package's
REINFORCE rule).  On ``meta`` tensors (shape inference) a draw answers an
empty tensor of its shape.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import random as _random
from ..base import torch_dtype
from ..context import as_device
from .register import add_alias, register_op


def _shape(shape):
    if shape is None:
        return (1,)
    return (int(shape),) if isinstance(shape, (int, np.integer)) else \
        tuple(int(s) for s in shape)


def _draw_shape(shape):
    """The trailing draw shape of a ``_sample_*`` op (one draw an element
    by default)."""
    if shape is None or shape == () or shape == 0:
        return ()
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s) for s in shape)


def _dt(dtype, default="float32"):
    return torch_dtype(dtype or default)


def _gamma(alpha: torch.Tensor, gen) -> torch.Tensor:
    return torch._standard_gamma(alpha, generator=gen)


def _nb(k: torch.Tensor, p: torch.Tensor, gen) -> torch.Tensor:
    """Negative binomial draws: Poisson of Gamma(k, (1 - p) / p)."""
    lam = _gamma(k, gen) * ((1.0 - p) / p)
    return torch.poisson(lam, generator=gen)


# ---- scalar-parameter draws -------------------------------------------

def _scalar(draw, default="float32"):
    """A maker for ``draw(shape, dtype, device, generator, **params)``."""
    def maker(shape=None, dtype=None, ctx=None, **params):
        shp, dt = _shape(shape), _dt(dtype, default)

        def fn():
            dev = as_device(ctx)
            return draw(shp, dt, dev, _random.generator(dev), **params)
        return fn
    return maker


def uniform_maker(low=0.0, high=1.0, shape=None, dtype=None, ctx=None):
    return _scalar(lambda s, dt, dev, gen: torch.empty(
        s, dtype=dt, device=dev).uniform_(float(low), float(high),
                                          generator=gen))(shape, dtype, ctx)


def normal_maker(loc=0.0, scale=1.0, shape=None, dtype=None, ctx=None):
    return _scalar(lambda s, dt, dev, gen: torch.empty(
        s, dtype=dt, device=dev).normal_(float(loc), float(scale),
                                         generator=gen))(shape, dtype, ctx)


def randint_maker(low=0, high=1, shape=None, dtype="int32", ctx=None):
    return _scalar(lambda s, dt, dev, gen: torch.randint(
        int(low), int(high), s, dtype=dt, device=dev, generator=gen),
        "int32")(shape, dtype, ctx)


def _work(dt: torch.dtype) -> torch.dtype:
    """The floating type a draw computes in: float64 for a float64
    result, else float32 (an integer or 16-bit result is rounded after)."""
    return torch.float64 if dt == torch.float64 else torch.float32


def gamma_maker(alpha=1.0, beta=1.0, shape=None, dtype=None, ctx=None):
    def draw(s, dt, dev, gen):
        a = torch.full(s, float(alpha), dtype=_work(dt), device=dev)
        return (_gamma(a, gen) * float(beta)).to(dt)
    return _scalar(draw)(shape, dtype, ctx)


def exponential_maker(lam=1.0, shape=None, dtype=None, ctx=None,
                      scale=None):
    sc = float(scale) if scale is not None else 1.0 / float(lam)

    def draw(s, dt, dev, gen):
        e = torch.empty(s, dtype=_work(dt), device=dev).exponential_(
            1.0, generator=gen)
        return (e * sc).to(dt)
    return _scalar(draw)(shape, dtype, ctx)


def poisson_maker(lam=1.0, shape=None, dtype=None, ctx=None):
    def draw(s, dt, dev, gen):
        rate = torch.full(s, float(lam), dtype=torch.float32, device=dev)
        return torch.poisson(rate, generator=gen).to(dt)
    return _scalar(draw)(shape, dtype, ctx)


def negative_binomial_maker(k=1, p=1.0, shape=None, dtype=None, ctx=None):
    def draw(s, dt, dev, gen):
        kk = torch.full(s, float(k), dtype=torch.float32, device=dev)
        return _nb(kk, torch.tensor(float(p), device=dev), gen).to(dt)
    return _scalar(draw)(shape, dtype, ctx)


def gnb_maker(mu=1.0, alpha=1.0, shape=None, dtype=None, ctx=None):
    k = 1.0 / float(alpha)
    p = k / (k + float(mu))

    def draw(s, dt, dev, gen):
        kk = torch.full(s, k, dtype=torch.float32, device=dev)
        return _nb(kk, torch.tensor(p, device=dev), gen).to(dt)
    return _scalar(draw)(shape, dtype, ctx)


# ---- *_like draws -----------------------------------------------------

def _like(draw):
    """A ``*_like`` fn: ``draw(shape, dtype, device, generator)`` in the
    input's shape, device and (unless ``dtype``) dtype."""
    def make(dtype):
        def fn(data):
            dt = data.dtype if dtype is None else torch_dtype(dtype)
            if data.device.type == "meta":
                return torch.empty(data.shape, dtype=dt, device="meta")
            return draw(tuple(data.shape), dt, data.device,
                        _random.generator(data.device))
        return fn
    return make


def uniform_like_maker(low=0.0, high=1.0, dtype=None):
    return _like(lambda s, dt, dev, gen: torch.empty(
        s, dtype=dt, device=dev).uniform_(float(low), float(high),
                                          generator=gen))(dtype)


def normal_like_maker(loc=0.0, scale=1.0, dtype=None):
    return _like(lambda s, dt, dev, gen: torch.empty(
        s, dtype=dt, device=dev).normal_(float(loc), float(scale),
                                         generator=gen))(dtype)


def gamma_like_maker(alpha=1.0, beta=1.0, dtype=None):
    return _like(lambda s, dt, dev, gen: (_gamma(torch.full(
        s, float(alpha), dtype=_work(dt), device=dev), gen)
        * float(beta)).to(dt))(dtype)


def exponential_like_maker(lam=1.0, dtype=None):
    return _like(lambda s, dt, dev, gen: (torch.empty(
        s, dtype=_work(dt), device=dev).exponential_(1.0, generator=gen)
        / float(lam)).to(dt))(dtype)


def poisson_like_maker(lam=1.0, dtype=None):
    return _like(lambda s, dt, dev, gen: torch.poisson(torch.full(
        s, float(lam), dtype=torch.float32, device=dev),
        generator=gen).to(dt))(dtype)


# ---- per-element-parameter draws --------------------------------------

def _sample(n_params: int, draw):
    """A ``_sample_*`` maker: the parameters broadcast to ``s``, each
    expanded over the trailing draw axes to ``s + shape``; ``draw(params,
    out_shape, dtype, generator)``."""
    def maker(shape=None, dtype=None, ctx=None):
        tail, dt = _draw_shape(shape), _dt(dtype)

        def fn(*params):
            params = torch.broadcast_tensors(*params) if n_params > 1 \
                else params
            out_shape = tuple(params[0].shape) + tail
            dev = params[0].device
            if dev.type == "meta":
                return torch.empty(out_shape, dtype=dt, device=dev)
            full = [p.reshape(p.shape + (1,) * len(tail)).expand(out_shape)
                    for p in params]
            return draw(full, out_shape, dt, _random.generator(dev)).to(dt)
        return fn
    return maker


def _sample_uniform(ps, s, dt, gen):
    lo, hi = ps
    u = torch.empty(s, dtype=_work(dt), device=lo.device).uniform_(
        generator=gen)
    return lo + u * (hi - lo)


def _sample_normal(ps, s, dt, gen):
    mu, sigma = ps
    z = torch.empty(s, dtype=_work(dt), device=mu.device).normal_(
        generator=gen)
    return mu + z * sigma


def _sample_gamma(ps, s, dt, gen):
    alpha, beta = ps
    return _gamma(alpha.to(_work(dt)).contiguous(), gen) * beta


def _sample_exponential(ps, s, dt, gen):
    lam, = ps
    e = torch.empty(s, dtype=_work(dt), device=lam.device).exponential_(
        1.0, generator=gen)
    return e / lam


def _sample_poisson(ps, s, dt, gen):
    lam, = ps
    return torch.poisson(lam.float().contiguous(), generator=gen)


def _sample_nb(ps, s, dt, gen):
    k, p = ps
    return _nb(k.float().contiguous(), p, gen)


def _sample_gnb(ps, s, dt, gen):
    mu, alpha = ps
    k = 1.0 / torch.clamp(alpha, min=1e-12)
    p = 1.0 / (1.0 + alpha * mu)
    return _nb(k.float().contiguous(), p, gen)


def sample_multinomial_maker(shape=None, get_prob=False, dtype="int32",
                             ctx=None):
    squeeze = shape in (None, ())
    n = 1 if squeeze else (int(shape) if isinstance(shape, (int, np.integer))
                           else int(np.prod(shape)))
    dt = _dt(dtype, "int32")

    def fn(p):
        batch = tuple(p.shape[:-1])
        if p.device.type == "meta":
            out = torch.empty(batch + (() if squeeze else (n,)), dtype=dt,
                              device="meta")
            return (out, out.to(p.dtype)) if get_prob else out
        rows = p.reshape(-1, p.shape[-1])
        with torch.no_grad():
            samples = torch.multinomial(
                torch.clamp(rows.detach(), min=1e-30), n, replacement=True,
                generator=_random.generator(p.device))
        out = samples.reshape(batch + (n,))
        res = out[..., 0] if squeeze else out
        if not get_prob:
            return res.to(dt)
        lp = torch.log(torch.clamp(rows, min=1e-30)).gather(1, samples) \
            .reshape(batch + (n,))
        return res.to(dt), lp[..., 0] if squeeze else lp
    return fn


def shuffle_maker(ctx=None):
    def fn(data):
        if data.device.type == "meta":
            return torch.empty_like(data)
        perm = torch.randperm(data.shape[0], device=data.device,
                              generator=_random.generator(data.device))
        return data.index_select(0, perm)
    return fn


def _register():
    draws = (
        ("_random_uniform", uniform_maker, ("random_uniform",)),
        ("_random_normal", normal_maker, ("random_normal",)),
        ("_random_randint", randint_maker, ("random_randint",)),
        ("_random_gamma", gamma_maker, ()),
        ("_random_exponential", exponential_maker, ()),
        ("_random_poisson", poisson_maker, ()),
        ("_random_negative_binomial", negative_binomial_maker, ()),
        ("_random_generalized_negative_binomial", gnb_maker, ()),
        ("_random_uniform_like", uniform_like_maker, ()),
        ("_random_normal_like", normal_like_maker, ()),
        ("_random_gamma_like", gamma_like_maker, ()),
        ("_random_exponential_like", exponential_like_maker, ()),
        ("_random_poisson_like", poisson_like_maker, ()),
        ("_sample_uniform", _sample(2, _sample_uniform), ()),
        ("_sample_normal", _sample(2, _sample_normal), ()),
        ("_sample_gamma", _sample(2, _sample_gamma), ()),
        ("_sample_exponential", _sample(1, _sample_exponential), ()),
        ("_sample_poisson", _sample(1, _sample_poisson), ()),
        ("_sample_negative_binomial", _sample(2, _sample_nb), ()),
        ("_sample_generalized_negative_binomial", _sample(2, _sample_gnb),
         ()),
        ("_shuffle", shuffle_maker, ()))
    for name, maker, aliases in draws:
        register_op(name, maker, aliases=aliases, differentiable=False)
    register_op("_sample_multinomial", sample_multinomial_maker)
    add_alias("_sample_multinomial", "multinomial")


_register()
