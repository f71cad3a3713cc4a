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

The rest of ``mxnet_tpu/initializer.py`` (:25-365): ``Constant(value)``;
``MSRAPrelu`` (``Xavier("gaussian", factor_type, 2 / (1 + slope^2))``);
``Orthogonal`` (the orthogonal factor of the SVD of a uniform or normal
draw, scaled: its rows or columns are orthonormal times ``scale``);
``Bilinear`` (the bilinear upsampling kernel, the same values as the
JAX package's); ``Mixed`` (the first of ``patterns`` that matches the
name, from its start, picks the initializer); ``Load`` (the arrays of a
name -> array dict or an ``nd.save`` file, names without their
``arg:``/``aux:`` prefixes, else ``default_init``); ``create`` also takes
a function ``fn(name, arr)`` (MXNet's calling convention; ``arr`` is a
CPU tensor to fill) and refuses a class; ``register`` adds a class by
its lower-case name.
"""
from __future__ import annotations

import json
import math
import re

import numpy as np
import torch

from .base import MXNetError

__all__ = ["Initializer", "Uniform", "Normal", "Xavier", "Zero", "One",
           "Constant", "MSRAPrelu", "Orthogonal", "Bilinear", "LSTMBias",
           "Mixed", "Load", "InitDesc", "register", "create"]


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


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def init_weight(self, name, arr, generator):
        arr.copy_(torch.from_numpy(np.full(arr.shape, self.value,
                                           np.float32)))


class MSRAPrelu(Xavier):
    """He et al.'s initialization for PReLU units of slope ``slope``."""

    def __init__(self, factor_type: str = "avg", slope: float = 0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))
        self.slope = slope


class Orthogonal(Initializer):
    """``scale`` times the orthogonal factor of the SVD of a (rows,
    prod(other dims)) draw, uniform in [-1, 1] or standard normal."""

    def __init__(self, scale: float = 1.414, rand_type: str = "uniform"):
        self.scale = scale
        self.rand_type = rand_type

    def init_weight(self, name, arr, generator):
        nout, nin = arr.shape[0], math.prod(arr.shape[1:])
        tmp = torch.empty(nout, nin, dtype=torch.float64)
        if self.rand_type == "uniform":
            tmp.uniform_(-1.0, 1.0, generator=generator)
        else:
            tmp.normal_(0.0, 1.0, generator=generator)
        u, _, v = torch.linalg.svd(tmp, full_matrices=False)
        q = u if u.shape == tmp.shape else v
        arr.copy_((self.scale * q).reshape(arr.shape))


class Bilinear(Initializer):
    """The bilinear upsampling kernel of a (C, 1, K, K) deconvolution
    weight."""

    def init_weight(self, name, arr, generator):
        shape = arr.shape
        f = np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        i = np.arange(math.prod(shape))
        x, y = i % shape[3], (i // shape[3]) % shape[2]
        weight = (1 - np.abs(x / f - c)) * (1 - np.abs(y / f - c))
        arr.copy_(torch.from_numpy(weight.astype(np.float32)
                                   .reshape(shape)))


class Mixed(Initializer):
    """The initializer of the first pattern that matches the parameter's
    name from its start."""

    def __init__(self, patterns, initializers):
        if len(patterns) != len(initializers):
            raise MXNetError("patterns and initializers must pair up")
        self.map = [(re.compile(p), create(i))
                    for p, i in zip(patterns, initializers)]

    def __call__(self, name, arr, generator):
        for prog, init in self.map:
            if prog.match(name):
                init(name, arr, generator)
                return
        raise MXNetError(f"no initializer pattern matches {name!r}")

    init_weight = __call__


class Load(Initializer):
    """The arrays of ``param`` (a name -> array dict, or an ``nd.save``
    file of one), else ``default_init``."""

    def __init__(self, param, default_init=None, verbose=False):
        if isinstance(param, str):
            from .ndarray import load as nd_load
            param = nd_load(param, ctx="cpu")
        if not hasattr(param, "items"):
            raise MXNetError(
                "Load expects a name->NDArray dict (or a file saved from "
                "one); got a list: save params as a dict")
        self.param = {name[4:] if name.startswith(("arg:", "aux:"))
                      else name: arr for name, arr in param.items()}
        self.default_init = None if default_init is None \
            else create(default_init)
        self.verbose = verbose

    def __call__(self, name, arr, generator):
        if name in self.param:
            src = self.param[name]
            src = src._data if hasattr(src, "_data") else torch.as_tensor(src)
            if tuple(src.shape) != tuple(arr.shape):
                raise MXNetError(
                    f"Parameter {name!r} cannot be initialized from "
                    f"loading: incompatible shapes {tuple(src.shape)} vs "
                    f"{tuple(arr.shape)}")
            arr.copy_(src)
            return
        if self.default_init is None:
            raise MXNetError(
                f"Cannot Initialize parameter {name!r}: not found in the "
                f"loaded file and no default_init given")
        self.default_init(name, arr, generator)

    init_weight = __call__


class _CallableInit(Initializer):
    """A function ``fn(name, arr)`` as an initializer, by name or
    direct."""

    def __init__(self, fn):
        self._fn = fn

    def __call__(self, name, arr, generator):
        self._fn(name, arr)

    init_weight = __call__


_registry = {"uniform": Uniform, "normal": Normal, "xavier": Xavier,
             "zero": Zero, "zeros": Zero, "one": One, "ones": One,
             "constant": Constant, "msraprelu": MSRAPrelu,
             "orthogonal": Orthogonal, "bilinear": Bilinear,
             "lstmbias": LSTMBias}


def register(klass):
    """Make ``klass`` creatable by its lower-case name."""
    _registry[klass.__name__.lower()] = klass
    return klass


def create(init, **kwargs) -> Initializer:
    """An Initializer from None (the default ``Uniform(0.07)``), a name
    (with ``kwargs`` for its constructor), an instance, or a function
    ``fn(name, arr)``."""
    if init is None:
        return Uniform(0.07)
    if isinstance(init, Initializer):
        return init
    if isinstance(init, str):
        if init.lower() not in _registry:
            raise MXNetError(f"unknown initializer {init!r}")
        return _registry[init.lower()](**kwargs)
    if isinstance(init, type):
        raise MXNetError(f"cannot create initializer from the class "
                         f"{init!r}; pass an instance (e.g. "
                         f"{init.__name__}())")
    if callable(init):
        return _CallableInit(init)
    raise MXNetError(f"cannot create initializer from {init!r}")
