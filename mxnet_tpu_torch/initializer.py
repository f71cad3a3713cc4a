"""Parameter initializers: the layers' defaults, ``Normal`` and ``Xavier``.

Same rules as ``mxnet_tpu/initializer.py``: the default initializer is
``Uniform(0.07)``, and it dispatches on the parameter name (``*bias``,
``*beta`` and ``*running_mean``/``*moving_mean`` get zeros, ``*gamma``
and ``*running_var``/``*moving_var`` ones, everything else the random
draw), unless the name is an ``InitDesc`` whose ``__init__`` attribute
names another initializer (``LSTMBias`` for ``mx.rnn.LSTMCell``).
``Xavier`` takes the JAX package's fan rule: ``fan_in = shape[1] *
prod(shape[2:])``, ``fan_out = shape[0] * prod(shape[2:])``.
Draws come from a ``torch.Generator`` the caller seeds; they match the JAX
package in distribution, not bit for bit.  Fills run on CPU tensors, so one
seed gives the same weights whatever device the parameters then move to.
"""
from __future__ import annotations

import json
import math

import torch

from .base import MXNetError

__all__ = ["Initializer", "Uniform", "Normal", "Xavier", "Zero", "One",
           "LSTMBias", "InitDesc", "create"]


class InitDesc(str):
    """A parameter name carrying its variable's attributes (MXNet's
    ``mx.init.InitDesc``): an ``__init__`` attribute (``"zeros"``, or
    ``'["lstmbias", {"forget_bias": 1.0}]'`` as a string or parsed)
    overrides the name rules."""

    def __new__(cls, name, attrs=None):
        obj = super().__new__(cls, name)
        obj.attrs = attrs or {}
        return obj


def _explicit(desc) -> "Initializer":
    """The initializer an ``__init__`` attribute names."""
    if isinstance(desc, str):
        try:
            desc = json.loads(desc)
        except ValueError:
            return create(desc)
    if isinstance(desc, (list, tuple)):
        return create(desc[0], **(desc[1] if len(desc) > 1 else {}))
    return create(desc)


class Initializer:
    """Base initializer; ``__call__`` dispatches on the parameter name."""

    def __call__(self, name: str, arr: torch.Tensor,
                 generator: torch.Generator) -> None:
        desc = getattr(name, "attrs", {}).get("__init__")
        if desc:
            _explicit(desc).init_weight(str(name), arr, generator)
            return
        name = name.lower()
        if name.endswith(("bias", "beta", "running_mean", "moving_mean")):
            arr.zero_()
        elif name.endswith(("gamma", "running_var", "moving_var")):
            arr.fill_(1.0)
        else:
            self.init_weight(name, arr, generator)

    def init_weight(self, name: str, arr: torch.Tensor,
                    generator: torch.Generator) -> None:
        """Direct fill, bypassing the name dispatch (a parameter's own
        explicit initializer)."""
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}()"


class Uniform(Initializer):
    def __init__(self, scale: float = 0.07):
        self.scale = scale

    def init_weight(self, name, arr, generator):
        arr.uniform_(-self.scale, self.scale, generator=generator)


class Normal(Initializer):
    def __init__(self, sigma: float = 0.01):
        self.sigma = sigma

    def init_weight(self, name, arr, generator):
        arr.normal_(0.0, self.sigma, generator=generator)


def _fan(shape):
    """(fan_in, fan_out), with the receptive field of a conv weight."""
    hw = math.prod(shape[2:])
    return (shape[1] if len(shape) > 1 else shape[0]) * hw, shape[0] * hw


class Xavier(Initializer):
    """Scale ``sqrt(magnitude / factor)``, factor the mean of the fans
    (``avg``), ``fan_in`` (``in``) or ``fan_out`` (``out``); a uniform
    draw in [-scale, scale] or a normal one of that sigma."""

    def __init__(self, rnd_type: str = "uniform", factor_type: str = "avg",
                 magnitude: float = 3):
        if rnd_type not in ("uniform", "gaussian"):
            raise MXNetError(f"bad rnd_type {rnd_type!r}")
        if factor_type not in ("avg", "in", "out"):
            raise MXNetError(f"bad factor_type {factor_type!r}")
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def init_weight(self, name, arr, generator):
        fan_in, fan_out = _fan(arr.shape)
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                  "out": fan_out}[self.factor_type]
        scale = math.sqrt(self.magnitude / max(factor, 1.0))
        if self.rnd_type == "uniform":
            arr.uniform_(-scale, scale, generator=generator)
        else:
            arr.normal_(0.0, scale, generator=generator)


class Zero(Initializer):
    def init_weight(self, name, arr, generator):
        arr.zero_()


class One(Initializer):
    def init_weight(self, name, arr, generator):
        arr.fill_(1.0)


class LSTMBias(Initializer):
    """An LSTM's packed (i, f, c, o) bias: ``forget_bias`` on the forget
    gate's quarter, 0 elsewhere."""

    def __init__(self, forget_bias: float = 1.0):
        self.forget_bias = forget_bias

    def init_weight(self, name, arr, generator):
        n = arr.shape[0] // 4
        arr.zero_()
        arr[n:2 * n] = self.forget_bias


_registry = {"uniform": Uniform, "normal": Normal, "xavier": Xavier,
             "zero": Zero, "zeros": Zero, "one": One, "ones": One,
             "lstmbias": LSTMBias}


def create(init, **kwargs) -> Initializer:
    """An Initializer from None (the default ``Uniform(0.07)``), a name
    (with ``kwargs`` for its constructor), or an instance."""
    if init is None:
        return Uniform(0.07)
    if isinstance(init, Initializer):
        return init
    if isinstance(init, str) and init.lower() in _registry:
        return _registry[init.lower()](**kwargs)
    raise MXNetError(f"cannot create initializer from {init!r}")
