"""``mx.sym.random``: draws as graph nodes.

Counterpart of ``mxnet_tpu/symbol/random.py`` (:19-114): each call makes
a ``_random_*`` node (scalar parameters; ``shape`` None is ``(1,)``) or,
where a parameter is a ``Symbol``, a per-element ``_sample_*`` node, as
MXNet's ``_random_helper`` dispatches.  ``exponential`` takes the scale;
a ``Symbol`` scale becomes the rate ``1 / scale`` of
``_sample_exponential``.  The executor runs a node's op at each forward,
which draws from the device's generator (``mx.random.generator``), so
every ``forward`` draws afresh and ``mx.random.seed`` repeats them.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from ..ndarray.ops_random import _shape
from .register import apply_op
from .symbol import Symbol

__all__ = ["uniform", "normal", "randint", "exponential", "gamma",
           "poisson", "negative_binomial", "generalized_negative_binomial",
           "multinomial", "shuffle"]


def _attrs(shape, dtype, **params) -> Dict[str, Any]:
    attrs = dict(params, shape=_shape(shape))
    if dtype is not None:
        attrs["dtype"] = dtype
    return attrs


def _sample_attrs(shape, dtype) -> Dict[str, Any]:
    attrs = _attrs(shape, dtype)
    if shape is None:
        attrs.pop("shape")
    return attrs


def _scalar_or_sample(scalar_op: str, sample_op: str, params, shape, dtype,
                      names, name: Optional[str]):
    if any(isinstance(p, Symbol) for p in params):
        return apply_op(sample_op, list(params), _sample_attrs(shape, dtype),
                        name=name)
    return apply_op(scalar_op, [], _attrs(
        shape, dtype, **dict(zip(names, map(float, params)))), name=name)


def uniform(low=0.0, high=1.0, shape=None, dtype=None, name=None, **kwargs):
    return _scalar_or_sample("_random_uniform", "_sample_uniform",
                             [low, high], shape, dtype, ("low", "high"),
                             name)


def normal(loc=0.0, scale=1.0, shape=None, dtype=None, name=None, **kwargs):
    return _scalar_or_sample("_random_normal", "_sample_normal",
                             [loc, scale], shape, dtype, ("loc", "scale"),
                             name)


def gamma(alpha=1.0, beta=1.0, shape=None, dtype=None, name=None, **kwargs):
    return _scalar_or_sample("_random_gamma", "_sample_gamma",
                             [alpha, beta], shape, dtype, ("alpha", "beta"),
                             name)


def exponential(scale=1.0, shape=None, dtype=None, name=None, **kwargs):
    if isinstance(scale, Symbol):
        return apply_op("_sample_exponential", [1.0 / scale],
                        _sample_attrs(shape, dtype), name=name)
    return apply_op("_random_exponential", [],
                    _attrs(shape, dtype, scale=float(scale)), name=name)


def poisson(lam=1.0, shape=None, dtype=None, name=None, **kwargs):
    return _scalar_or_sample("_random_poisson", "_sample_poisson", [lam],
                             shape, dtype, ("lam",), name)


def negative_binomial(k=1, p=1.0, shape=None, dtype=None, name=None,
                      **kwargs):
    return _scalar_or_sample("_random_negative_binomial",
                             "_sample_negative_binomial", [k, p], shape,
                             dtype, ("k", "p"), name)


def generalized_negative_binomial(mu=1.0, alpha=1.0, shape=None, dtype=None,
                                  name=None, **kwargs):
    return _scalar_or_sample("_random_generalized_negative_binomial",
                             "_sample_generalized_negative_binomial",
                             [mu, alpha], shape, dtype, ("mu", "alpha"),
                             name)


def randint(low, high, shape=None, dtype="int32", name=None, **kwargs):
    return apply_op("_random_randint", [],
                    _attrs(shape, dtype, low=int(low), high=int(high)),
                    name=name)


def multinomial(data, shape=None, get_prob=False, dtype="int32", name=None,
                **kwargs):
    attrs: Dict[str, Any] = {"get_prob": bool(get_prob), "dtype": dtype}
    if shape is not None:
        attrs["shape"] = shape if isinstance(shape, int) else tuple(shape)
    return apply_op("_sample_multinomial", [data], attrs, name=name)


def shuffle(data, name=None, **kwargs):
    return apply_op("_shuffle", [data], {}, name=name)
