"""Elementwise operators: unary, binary broadcast, comparisons and the
scalar forms.

Counterpart of ``mxnet_tpu/ndarray/ops_elemwise.py`` (unary :36-83,
binary :106-127, comparisons :130-153, scalar pairs :181-206), with
MXNet's quirks:

- comparisons and logical ops return 0/1 in the left input's dtype, not
  bool;
- a scalar is cast to the array's dtype before the op (``int_array +
  2.7`` adds 2; a bfloat16 array multiplies by the scalar rounded to
  bfloat16), where torch would promote or compute in fp32.

``mod`` is Python's (the sign of the divisor), as ``jnp.mod``; ``round``
rounds half to even, as ``jnp.round``.  A scalar op takes its scalar as a
parameter (``nd._plus_scalar(x, scalar=2)``) or, from the dunders, as its
second input.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .register import register_op, simple_op


def _cbrt(x):
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


_UNARY = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "hard_sigmoid": lambda x: torch.clamp(0.2 * x + 0.5, 0.0, 1.0),
    "tanh": torch.tanh,
    "softsign": lambda x: x / (1 + torch.abs(x)),
    "softrelu": F.softplus,
    "exp": torch.exp,
    "expm1": torch.expm1,
    "log": torch.log,
    "log10": torch.log10,
    "log2": torch.log2,
    "log1p": torch.log1p,
    "sqrt": torch.sqrt,
    "rsqrt": torch.rsqrt,
    "cbrt": _cbrt,
    "rcbrt": lambda x: 1.0 / _cbrt(x),
    "square": torch.square,
    "abs": torch.abs,
    "sign": torch.sign,
    "round": torch.round,
    "rint": torch.round,
    "fix": torch.trunc,
    "floor": torch.floor,
    "ceil": torch.ceil,
    "trunc": torch.trunc,
    "negative": torch.neg,
    "reciprocal": torch.reciprocal,
    "erf": torch.erf,
    "erfinv": torch.erfinv,
    "gamma": lambda x: torch.exp(torch.lgamma(x)),
    "gammaln": torch.lgamma,
    "digamma": torch.digamma,
    "sin": torch.sin,
    "cos": torch.cos,
    "tan": torch.tan,
    "arcsin": torch.asin,
    "arccos": torch.acos,
    "arctan": torch.atan,
    "sinh": torch.sinh,
    "cosh": torch.cosh,
    "arcsinh": torch.asinh,
    "arccosh": torch.acosh,
    "arctanh": torch.atanh,
    "degrees": torch.rad2deg,
    "radians": torch.deg2rad,
    "logical_not": lambda x: (x == 0).to(x.dtype),
}

_BINARY = {
    "broadcast_add": (torch.add, ("elemwise_add", "_plus",
                                  "broadcast_plus")),
    "broadcast_sub": (torch.sub, ("elemwise_sub", "_minus",
                                  "broadcast_minus")),
    "broadcast_mul": (torch.mul, ("elemwise_mul", "_mul")),
    "broadcast_div": (torch.div, ("elemwise_div", "_div")),
    "broadcast_mod": (torch.remainder, ("_mod",)),
    "broadcast_power": (torch.pow, ("_power", "pow")),
    "broadcast_maximum": (torch.maximum, ("maximum", "_maximum")),
    "broadcast_minimum": (torch.minimum, ("minimum", "_minimum")),
    "broadcast_hypot": (torch.hypot, ()),
}

_COMPARE = {
    "broadcast_equal": (torch.eq, ("_equal",)),
    "broadcast_not_equal": (torch.ne, ("_not_equal",)),
    "broadcast_greater": (torch.gt, ("_greater",)),
    "broadcast_greater_equal": (torch.ge, ("_greater_equal",)),
    "broadcast_lesser": (torch.lt, ("_lesser",)),
    "broadcast_lesser_equal": (torch.le, ("_lesser_equal",)),
    "broadcast_logical_and": (lambda x, y: (x != 0) & (y != 0),
                              ("logical_and",)),
    "broadcast_logical_or": (lambda x, y: (x != 0) | (y != 0),
                             ("logical_or",)),
    "broadcast_logical_xor": (lambda x, y: (x != 0) ^ (y != 0),
                              ("logical_xor",)),
}

# name: fn(x, s) with s a number in x's dtype
_SCALAR = {
    "_plus_scalar": lambda x, s: x + s,
    "_minus_scalar": lambda x, s: x - s,
    "_rminus_scalar": lambda x, s: s - x,
    "_mul_scalar": lambda x, s: x * s,
    "_div_scalar": lambda x, s: x / s,
    "_rdiv_scalar": lambda x, s: s / x,
    "_mod_scalar": lambda x, s: x % s,
    "_rmod_scalar": lambda x, s: s % x,
    "_power_scalar": lambda x, s: x ** s,
    "_rpower_scalar": lambda x, s: s ** x,
    "_maximum_scalar": lambda x, s: torch.clamp(x, min=s),
    "_minimum_scalar": lambda x, s: torch.clamp(x, max=s),
}

_SCALAR_COMPARE = {
    "_equal_scalar": torch.eq,
    "_not_equal_scalar": torch.ne,
    "_greater_scalar": torch.gt,
    "_greater_equal_scalar": torch.ge,
    "_lesser_scalar": torch.lt,
    "_lesser_equal_scalar": torch.le,
    "_logical_and_scalar": lambda x, s: (x != 0) & (s != 0),
    "_logical_or_scalar": lambda x, s: (x != 0) | (s != 0),
    "_logical_xor_scalar": lambda x, s: (x != 0) ^ (s != 0),
}


def cast_scalar(s, x: torch.Tensor):
    """The number ``s`` in ``x``'s dtype (MXNet casts the scalar before
    the op): truncated for an integer array, rounded to a 16-bit float
    array's precision.  It stays a Python number, which torch takes
    without a copy to the device."""
    if isinstance(s, torch.Tensor):
        s = s.item()
    if x.dtype == torch.bool:
        return bool(s)
    if not x.is_floating_point():
        return math.trunc(s)
    if x.dtype in (torch.float16, torch.bfloat16):
        return torch.tensor(float(s), dtype=x.dtype).item()
    return float(s)


def _compare(fn):
    def f(x, y):
        return fn(x, y).to(x.dtype)
    return f


def _scalar(fn):
    def maker(scalar=None):
        def f(x, s=scalar):
            return fn(x, cast_scalar(s, x))
        return f
    return maker


def _scalar_compare(fn):
    def maker(scalar=None):
        def f(x, s=scalar):
            return fn(x, cast_scalar(s, x)).to(x.dtype)
        return f
    return maker


def _clip(a_min=None, a_max=None):
    def f(x):
        return torch.clamp(x, a_min, a_max)
    return f


def _register():
    for name, fn in _UNARY.items():
        simple_op(name, fn)
    register_op("clip", _clip)
    for name, (fn, aliases) in _BINARY.items():
        simple_op(name, fn, aliases=aliases)
    for name, (fn, aliases) in _COMPARE.items():
        simple_op(name, _compare(fn), aliases=aliases)
    for name, fn in _SCALAR.items():
        register_op(name, _scalar(fn))
    for name, fn in _SCALAR_COMPARE.items():
        register_op(name, _scalar_compare(fn))


_register()
