"""Sampling operators: ``_random_uniform``, ``_random_normal`` and
``_random_randint``.

Counterpart of ``mxnet_tpu/ndarray/ops_random.py`` (:78-160): ops without
tensor inputs whose parameters carry the distribution, ``shape`` (None
is ``(1,)``), ``dtype`` (float32; int32 for ``randint``) and ``ctx`` (the
current context if None).  Each draw takes the generator of its device
(``mx.random``): reproducible under ``mx.random.seed``, not equal to the
JAX package's ``jax.random`` streams.  Draws take no gradient.
"""
from __future__ import annotations

import torch

from .. import random as _random
from ..base import torch_dtype
from ..context import as_device
from .register import register_op


def _shape(shape):
    if shape is None:
        return (1,)
    return (int(shape),) if isinstance(shape, int) else \
        tuple(int(s) for s in shape)


def uniform_maker(low=0.0, high=1.0, shape=None, dtype=None, ctx=None):
    shp, dt = _shape(shape), torch_dtype(dtype or "float32")

    def fn():
        dev = as_device(ctx)
        return torch.empty(shp, dtype=dt, device=dev).uniform_(
            float(low), float(high), generator=_random.generator(dev))
    return fn


def normal_maker(loc=0.0, scale=1.0, shape=None, dtype=None, ctx=None):
    shp, dt = _shape(shape), torch_dtype(dtype or "float32")

    def fn():
        dev = as_device(ctx)
        return torch.empty(shp, dtype=dt, device=dev).normal_(
            float(loc), float(scale), generator=_random.generator(dev))
    return fn


def randint_maker(low=0, high=1, shape=None, dtype="int32", ctx=None):
    shp, dt = _shape(shape), torch_dtype(dtype or "int32")

    def fn():
        dev = as_device(ctx)
        return torch.randint(int(low), int(high), shp, dtype=dt, device=dev,
                             generator=_random.generator(dev))
    return fn


register_op("_random_uniform", uniform_maker, aliases=("random_uniform",))
register_op("_random_normal", normal_maker, aliases=("random_normal",))
register_op("_random_randint", randint_maker, aliases=("random_randint",))
