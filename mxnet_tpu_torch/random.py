"""Global random state: ``mx.random.seed()`` and one generator per device.

Counterpart of ``mxnet_tpu/random.py`` (``seed`` :27).  MXNet keeps a
generator per device, seeded from one global seed; the port keeps one
``torch.Generator`` per torch device, made on first use from the last
seed (0 before any).  ``seed(s)`` (``ctx="all"``) reseeds every device's
generator, ``seed(s, ctx=gpu(0))`` that device's alone.  Draws are
reproducible under a seed; they are not equal to the JAX package's
``jax.random`` streams (a threefry key split per draw), nor to MXNet's.

The draws of ``mx.nd.random`` (``uniform``, ``normal``, ``randn``,
``randint``, ``exponential``, ``gamma``, ``poisson``,
``negative_binomial``, ``generalized_negative_binomial``,
``multinomial``, ``shuffle``, ``bernoulli``) are re-exported, as MXNet's
``mx.random`` does (the JAX module's ``__getattr__`` :79).
"""
from __future__ import annotations

import threading
from typing import Dict

import torch

from .context import DeviceLike, as_device

__all__ = ["seed", "generator", "uniform", "normal", "randn", "randint",
           "exponential", "gamma", "poisson", "negative_binomial",
           "generalized_negative_binomial", "multinomial", "shuffle",
           "bernoulli"]

_lock = threading.Lock()
_seed = 0
_generators: Dict[torch.device, torch.Generator] = {}


def seed(seed_state: int, ctx: DeviceLike = "all") -> None:
    """Seed the generator of every device (``ctx="all"``), or of one."""
    global _seed
    with _lock:
        if isinstance(ctx, str) and ctx == "all":
            _seed = int(seed_state)
            for gen in _generators.values():
                gen.manual_seed(_seed)
        else:
            _gen_locked(as_device(ctx)).manual_seed(int(seed_state))


def _gen_locked(dev: torch.device) -> torch.Generator:
    gen = _generators.get(dev)
    if gen is None:
        gen = _generators[dev] = torch.Generator(device=dev)
        gen.manual_seed(_seed)
    return gen


def generator(ctx: DeviceLike = None) -> torch.Generator:
    """The generator of ``ctx``'s device (the current context's if None)."""
    dev = as_device(ctx)
    gen = _generators.get(dev)
    if gen is None:
        with _lock:
            gen = _gen_locked(dev)
    return gen


_DRAWS = ("uniform", "normal", "randn", "randint", "exponential", "gamma",
          "poisson", "negative_binomial", "generalized_negative_binomial",
          "multinomial", "shuffle", "bernoulli")


def __getattr__(name):
    # MXNet's mx.random re-exports the draws of mx.nd.random (JAX :79);
    # looked up lazily (ndarray.random imports this module)
    if name in _DRAWS:
        from .ndarray import random as _ndrandom
        return getattr(_ndrandom, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
