"""``mx.nd.random``: the draws of MXNet's ``mx.nd.random`` module.

Counterpart of ``mxnet_tpu/ndarray/random.py``.  Each draw is a registry
op of ``ops_random.py`` and returns an ``NDArray`` (or fills ``out``):

- ``uniform``, ``normal``, ``gamma``, ``poisson``, ``negative_binomial``
  and ``generalized_negative_binomial`` take scalar parameters (the
  ``_random_*`` op, ``shape`` draws on ``ctx``, the current context if
  None) or array parameters (the per-element ``_sample_*`` op: the
  parameters' shape followed by ``shape``), MXNet's ``_random_helper``
  rule (``_dispatch``, JAX :39);
- ``exponential`` takes the scale (the mean): a scalar goes to
  ``_random_exponential(scale=...)``, an array to ``_sample_exponential``
  as the rate ``1 / scale``;
- ``randn``, ``randint``, ``multinomial`` (``_sample_multinomial``, with
  ``get_prob`` the log-probabilities too), ``shuffle`` (``_shuffle``,
  along the first axis), ``bernoulli`` (0/1 draws with probability
  ``prob``), the ``sample_*`` forms (array parameters) and the
  ``*_like`` forms (the input's shape, device and dtype).

Every draw takes the device's generator (``mx.random.generator``).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import random as _grandom
from ..base import torch_dtype
from ..context import as_device
from .ndarray import NDArray
from .register import invoke_by_name

__all__ = ["uniform", "normal", "randn", "randint", "exponential", "gamma",
           "poisson", "negative_binomial", "generalized_negative_binomial",
           "multinomial", "shuffle", "bernoulli", "sample_uniform",
           "sample_normal", "sample_gamma", "sample_exponential",
           "sample_poisson", "sample_negative_binomial",
           "sample_generalized_negative_binomial", "sample_multinomial",
           "uniform_like", "normal_like", "gamma_like", "exponential_like",
           "poisson_like", "randint_like"]


def _dtype_attr(dtype):
    return dtype if isinstance(dtype, str) else str(torch_dtype(dtype)) \
        .replace("torch.", "")


def _is_tensor_param(p) -> bool:
    return isinstance(p, (NDArray, torch.Tensor, np.ndarray, list))


def _draw(op, shape, dtype, ctx, out, **params):
    if out is not None and shape is None:
        shape = out.shape
    attrs = {"shape": shape, "ctx": ctx, **params}
    if dtype is not None:
        attrs["dtype"] = _dtype_attr(dtype)
    return invoke_by_name(op, [], attrs, out=out)


def _sample(op, params, shape, dtype, out=None, **extra):
    arrs = [p if isinstance(p, (NDArray, torch.Tensor))
            else np.asarray(p, np.float32) for p in params]
    attrs = dict(extra)
    if shape is not None:
        attrs["shape"] = shape if isinstance(shape, int) else tuple(shape)
    if dtype is not None:
        attrs["dtype"] = _dtype_attr(dtype)
    return invoke_by_name(op, arrs, attrs, out=out)


def _dispatch(scalar_op, sample_op, params, names, shape, dtype, ctx, out):
    """MXNet's rule: all-scalar parameters draw with the ``_random_*``
    op, array parameters with the per-element ``_sample_*`` op."""
    if any(_is_tensor_param(p) for p in params):
        return _sample(sample_op, list(params), shape, dtype, out=out)
    return _draw(scalar_op, shape, dtype, ctx, out,
                 **dict(zip(names, (float(p) for p in params))))


def uniform(low=0.0, high=1.0, shape=None, dtype=None, ctx=None, out=None,
            **kwargs):
    return _dispatch("_random_uniform", "_sample_uniform", [low, high],
                     ("low", "high"), shape, dtype, ctx, out)


def normal(loc=0.0, scale=1.0, shape=None, dtype=None, ctx=None, out=None,
           **kwargs):
    return _dispatch("_random_normal", "_sample_normal", [loc, scale],
                     ("loc", "scale"), shape, dtype, ctx, out)


def randn(*shape, loc=0.0, scale=1.0, dtype=None, ctx=None, **kwargs):
    return normal(loc=loc, scale=scale, shape=shape or (1,), dtype=dtype,
                  ctx=ctx)


def randint(low, high, shape=None, dtype="int32", ctx=None, out=None,
            **kwargs):
    return _draw("_random_randint", shape, dtype, ctx, out,
                 low=int(low), high=int(high))


def exponential(scale=1.0, shape=None, dtype=None, ctx=None, out=None,
                **kwargs):
    if _is_tensor_param(scale):
        lam = 1.0 / scale if isinstance(scale, (NDArray, torch.Tensor)) \
            else 1.0 / np.asarray(scale, np.float32)
        return _sample("_sample_exponential", [lam], shape, dtype, out=out)
    return _draw("_random_exponential", shape, dtype, ctx, out,
                 scale=float(scale))


def gamma(alpha=1.0, beta=1.0, shape=None, dtype=None, ctx=None, out=None,
          **kwargs):
    return _dispatch("_random_gamma", "_sample_gamma", [alpha, beta],
                     ("alpha", "beta"), shape, dtype, ctx, out)


def poisson(lam=1.0, shape=None, dtype=None, ctx=None, out=None, **kwargs):
    return _dispatch("_random_poisson", "_sample_poisson", [lam], ("lam",),
                     shape, dtype, ctx, out)


def negative_binomial(k=1, p=1.0, shape=None, dtype=None, ctx=None,
                      out=None, **kwargs):
    return _dispatch("_random_negative_binomial",
                     "_sample_negative_binomial", [k, p], ("k", "p"),
                     shape, dtype, ctx, out)


def generalized_negative_binomial(mu=1.0, alpha=1.0, shape=None, dtype=None,
                                  ctx=None, out=None, **kwargs):
    return _dispatch("_random_generalized_negative_binomial",
                     "_sample_generalized_negative_binomial", [mu, alpha],
                     ("mu", "alpha"), shape, dtype, ctx, out)


def multinomial(data, shape=None, get_prob=False, dtype="int32", **kwargs):
    """Category indices drawn from (batched) probability rows."""
    attrs = {"get_prob": bool(get_prob), "dtype": dtype}
    if shape is not None:
        attrs["shape"] = shape if isinstance(shape, int) else tuple(shape)
    return invoke_by_name("_sample_multinomial", [data], attrs)


def shuffle(data, **kwargs):
    return invoke_by_name("_shuffle", [data], {})


def bernoulli(prob=0.5, shape=None, dtype=None, ctx=None, **kwargs):
    """0/1 draws, 1 with probability ``prob`` (not an MXNet 1.x op; the
    JAX package keeps it as a convenience)."""
    from .ops_random import _shape
    dev = as_device(ctx)
    p = torch.full(_shape(shape), float(prob), dtype=torch.float32,
                   device=dev)
    draw = torch.bernoulli(p, generator=_grandom.generator(dev))
    return NDArray(draw.to(torch_dtype(dtype or "float32")))


def sample_uniform(low, high, shape=None, dtype=None, **kwargs):
    return _sample("_sample_uniform", [low, high], shape, dtype)


def sample_normal(mu, sigma, shape=None, dtype=None, **kwargs):
    return _sample("_sample_normal", [mu, sigma], shape, dtype)


def sample_gamma(alpha, beta, shape=None, dtype=None, **kwargs):
    return _sample("_sample_gamma", [alpha, beta], shape, dtype)


def sample_exponential(lam, shape=None, dtype=None, **kwargs):
    return _sample("_sample_exponential", [lam], shape, dtype)


def sample_poisson(lam, shape=None, dtype=None, **kwargs):
    return _sample("_sample_poisson", [lam], shape, dtype)


def sample_negative_binomial(k, p, shape=None, dtype=None, **kwargs):
    return _sample("_sample_negative_binomial", [k, p], shape, dtype)


def sample_generalized_negative_binomial(mu, alpha, shape=None, dtype=None,
                                         **kwargs):
    return _sample("_sample_generalized_negative_binomial", [mu, alpha],
                   shape, dtype)


def sample_multinomial(data, shape=None, get_prob=False, dtype="int32",
                       **kwargs):
    return multinomial(data, shape=shape, get_prob=get_prob, dtype=dtype)


def _like(op, data, out=None, dtype=None, **params):
    if dtype is not None:
        params["dtype"] = _dtype_attr(dtype)
    return invoke_by_name(op, [data], params, out=out)


def uniform_like(data, low=0.0, high=1.0, dtype=None, out=None, **kwargs):
    return _like("_random_uniform_like", data, out=out, dtype=dtype,
                 low=float(low), high=float(high))


def normal_like(data, loc=0.0, scale=1.0, dtype=None, out=None, **kwargs):
    return _like("_random_normal_like", data, out=out, dtype=dtype,
                 loc=float(loc), scale=float(scale))


def gamma_like(data, alpha=1.0, beta=1.0, dtype=None, out=None, **kwargs):
    return _like("_random_gamma_like", data, out=out, dtype=dtype,
                 alpha=float(alpha), beta=float(beta))


def exponential_like(data, lam=1.0, dtype=None, out=None, **kwargs):
    return _like("_random_exponential_like", data, out=out, dtype=dtype,
                 lam=float(lam))


def poisson_like(data, lam=1.0, dtype=None, out=None, **kwargs):
    return _like("_random_poisson_like", data, out=out, dtype=dtype,
                 lam=float(lam))


def randint_like(data, low=0, high=10, dtype="int32", out=None, **kwargs):
    t = data._data if isinstance(data, NDArray) else data
    return _draw("_random_randint", tuple(t.shape), dtype, t.device, out,
                 low=int(low), high=int(high))
