"""``mx.nd.random``: ``uniform``, ``normal``, ``randn`` and ``randint``.

Counterpart of ``mxnet_tpu/ndarray/random.py`` (``uniform`` :63,
``normal`` :69, ``randn`` :75, ``randint`` :80) for scalar parameters:
each draw is its ``_random_*`` registry op (``ops_random.py``) and
returns an ``NDArray`` on ``ctx`` (the current context if None), or
fills ``out``.  The per-element ``_sample_*`` forms (array parameters)
are not ported.
"""
from __future__ import annotations

from .register import invoke_by_name

__all__ = ["uniform", "normal", "randn", "randint"]


def _draw(op, shape, dtype, ctx, out, **params):
    if out is not None and shape is None:
        shape = out.shape
    attrs = {"shape": shape, "ctx": ctx, **params}
    if dtype is not None:
        attrs["dtype"] = dtype
    return invoke_by_name(op, [], attrs, out=out)


def uniform(low=0.0, high=1.0, shape=None, dtype=None, ctx=None, out=None,
            **kwargs):
    return _draw("_random_uniform", shape, dtype, ctx, out,
                 low=float(low), high=float(high))


def normal(loc=0.0, scale=1.0, shape=None, dtype=None, ctx=None, out=None,
           **kwargs):
    return _draw("_random_normal", shape, dtype, ctx, out,
                 loc=float(loc), scale=float(scale))


def randn(*shape, loc=0.0, scale=1.0, dtype=None, ctx=None, **kwargs):
    return normal(loc=loc, scale=scale, shape=shape or (1,), dtype=dtype,
                  ctx=ctx)


def randint(low, high, shape=None, dtype="int32", ctx=None, out=None,
            **kwargs):
    return _draw("_random_randint", shape, dtype, ctx, out,
                 low=int(low), high=int(high))
