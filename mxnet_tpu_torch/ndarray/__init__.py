"""``mx.nd``: ``NDArray``, the operator frontends and array creation.

Counterpart of ``mxnet_tpu/ndarray/__init__.py``.  The frontends are made
from the op registry (``register.make_frontend``) for every op the
``ops_*`` modules register; each takes ``NDArray``s (and returns them)
or tensors (and returns tensors), see ``register.py``.  The fluent
methods (``x.sum(axis)``, ``x.exp()``, ``x.transpose()``, ...) delegate
to the frontends with the array as first input (``_FLUENT_METHODS`` :57,
``_attach_fluent`` :71).  Hand-written frontends: the optimizer updates
(``ops_optimizer.py``; in place on tensors, MXNet's convention on
``NDArray``s), ``Custom`` (``ops_custom.py``), ``split_v2`` (sections or indices
positional) and ``_set_value`` (``out=`` only),
``flash_attention`` (the ``_contrib_flash_attention`` op with its
inputs by keyword), the draws of ``nd.random`` (also flat:
``nd.random_gamma``, ``nd.sample_normal``, ``nd.shuffle``, ...),
``waitall``, ``save`` and ``load``.  ``nd.contrib`` holds the
``_contrib_*`` ops by their short names (the detection ops of
``ops_contrib.py``, ``fft``, ``boolean_mask``, ...), ``nd.image`` the
``_image_*`` ops
(``ops_image.py``).
"""
import sys as _sys

import numpy as np

from . import (ops_contrib, ops_control_flow, ops_ctc,  # noqa: F401
               ops_elemwise, ops_image, ops_linalg, ops_matrix, ops_misc,
               ops_nn, ops_optimizer, ops_quantization, ops_random,
               ops_reduce, ops_sldwin, ops_spatial, ops_tail)
from . import contrib, image, random, utils
from .ndarray import (NDArray, arange, array, empty, eye, full, linspace,
                      moveaxis, ones, zeros)
from .ops_custom import Custom
from .ops_optimizer import (adagrad_update, adam_update, adamw_update,
                            ftml_update, ftrl_update, group_adagrad_update,
                            lamb_update_phase1, lamb_update_phase2,
                            lars_trust, mp_adamw_update,
                            mp_lamb_update_phase1, mp_lamb_update_phase2,
                            mp_nag_mom_update, mp_sgd_mom_update,
                            mp_sgd_update, multi_lars,
                            multi_mp_sgd_mom_update, multi_sgd_mom_update,
                            multi_sgd_update, multi_sum_sq, nag_mom_update,
                            rmsprop_update, rmspropalex_update,
                            sgd_mom_update, sgd_update, signsgd_update,
                            signum_update)
from ..base import MXNetError
from .register import _registry, get_op, invoke, list_ops, make_frontend
from .utils import load, save

_this = _sys.modules[__name__]


def flash_attention(q, k, v, valid_len=None, causal=False, scale=None,
                    out=None, name=None):
    """``mx.nd.flash_attention``: the ``_contrib_flash_attention`` op, its
    inputs positional or by keyword.  NDArrays in give NDArrays out
    (recorded under ``autograd.record()``); tensors in give tensors, with
    torch's grad mode as the caller set it."""
    inputs = [q, k, v] + ([] if valid_len is None else [valid_len])
    return invoke(get_op("_contrib_flash_attention"), inputs,
                  {"causal": causal, "scale": scale}, out=out)


def split_v2(ary, indices_or_sections=None, axis=0, squeeze_axis=False,
             **kwargs):
    """MXNet's ``nd.split_v2``: ``indices_or_sections`` an int (equal
    sections) or split indices (a leading 0, the raw op's segment start,
    is accepted); ``sections=``/``indices=`` work too."""
    if indices_or_sections is not None:
        if isinstance(indices_or_sections, (int, np.integer)):
            kwargs["sections"] = int(indices_or_sections)
        else:
            kwargs["indices"] = tuple(indices_or_sections)
    out = kwargs.pop("out", None)
    kwargs.pop("name", None)
    kwargs.setdefault("axis", axis)
    kwargs.setdefault("squeeze_axis", squeeze_axis)
    return invoke(get_op("split_v2"), [ary], kwargs, out=out)


def _set_value(src=0.0, out=None, **kwargs):
    """MXNet's C-API form: fill ``out`` with ``src`` (no other input)."""
    if out is None:
        raise MXNetError("_set_value requires out=")
    return invoke(get_op("_set_value"), [out], {"src": float(src)}, out=out)


# the flat forms of ``nd.random`` (JAX :161-180): MXNet's frontends, which
# take scalar or array parameters, before the registry's own
for _name in ("uniform", "normal", "randint", "gamma", "exponential",
              "poisson", "negative_binomial"):
    setattr(_this, "random_" + _name, getattr(random, _name))
for _name in ("sample_uniform", "sample_normal", "sample_gamma",
              "sample_exponential", "sample_poisson",
              "sample_negative_binomial",
              "sample_generalized_negative_binomial", "shuffle",
              "uniform_like", "normal_like", "gamma_like",
              "exponential_like", "poisson_like", "randint_like", "normal",
              "uniform"):
    setattr(_this, _name, getattr(random, _name))
sample_multinomial = random.multinomial

for _name, _op in list(_registry.items()):
    if not hasattr(_this, _name):
        setattr(_this, _name, make_frontend(_op))
# the optimizer updates by their ``_contrib_`` names: the hand-written
# frontends (in place on tensors), as under their short names
for _name in ("group_adagrad_update", "adamw_update", "mp_adamw_update"):
    setattr(_this, "_contrib_" + _name, getattr(_this, _name))
    setattr(contrib, _name, getattr(_this, _name))

#: the JAX package's fluent list (``mxnet_tpu/ndarray/__init__.py:57-69``)
#: and the port's earlier one, which holds its core methods
_FLUENT_METHODS = (
    "sum", "mean", "prod", "max", "min", "argmax", "argmin", "transpose",
    "dot", "broadcast_to", "broadcast_like", "expand_dims", "squeeze",
    "slice", "slice_axis", "take", "pick", "one_hot", "tile", "repeat",
    "flip", "swapaxes", "clip", "abs", "sign", "round", "floor", "ceil",
    "trunc", "rint", "fix", "exp", "expm1", "log", "log1p", "log2",
    "log10", "sqrt", "rsqrt", "cbrt", "rcbrt", "square", "reciprocal",
    "sin", "cos", "tan", "arcsin", "arccos", "arctan", "sinh", "cosh",
    "tanh", "arcsinh", "arccosh", "arctanh", "degrees", "radians", "erf",
    "erfinv", "gamma", "gammaln", "relu", "sigmoid", "softmax",
    "log_softmax", "zeros_like", "ones_like", "sort", "argsort", "topk",
    "softmin", "norm", "split", "slice_like", "diag", "nansum", "nanprod",
    "pad", "shape_array", "size_array", "reshape_like")

#: the methods an ``NDArray`` has by hand (views, host reads) that a
#: ``Symbol`` takes from the registry (the JAX package's
#: ``_CORE_SYM_METHODS``, :93-96)
_CORE_SYM_METHODS = (
    "sum", "mean", "max", "min", "argmax", "argmin", "reshape",
    "transpose", "dot", "broadcast_to", "flatten", "expand_dims",
    "squeeze", "slice")


def _attach_fluent(name):
    fn = getattr(_this, name)

    def method(self, *args, **kwargs):
        return fn(self, *args, **kwargs)
    method.__name__ = name
    method.__doc__ = f"Fluent form of ``mx.nd.{name}`` (self as data)."
    return method


for _m in _FLUENT_METHODS:
    if not hasattr(NDArray, _m):
        setattr(NDArray, _m, _attach_fluent(_m))


def _attach_symbol_fluent() -> None:
    """The same methods on ``Symbol``, each the ``mx.sym`` frontend of its
    op with the symbol as first input (``mxnet_tpu/ndarray/__init__.py:
    100-111``), so a ``hybrid_forward`` that calls ``x.reshape(...)``
    exports."""
    from ..symbol.register import _make_frontend
    from ..symbol.symbol import Symbol
    for m in _FLUENT_METHODS + _CORE_SYM_METHODS:
        if hasattr(Symbol, m) or m not in _registry:
            continue
        fe = _make_frontend(_registry[m].name)

        def method(self, *args, _fe=fe, **kwargs):
            return _fe(self, *args, **kwargs)
        method.__name__ = m
        method.__doc__ = f"Fluent form of ``mx.sym.{m}`` (self as data)."
        setattr(Symbol, m, method)


def waitall() -> None:
    """Block until every op queued on every device has run."""
    from ..engine import wait_all
    wait_all()


__all__ = sorted({"Custom", "NDArray", "arange", "array", "contrib",
                  "empty", "eye", "flash_attention", "full", "get_op",
                  "linspace", "list_ops", "load", "moveaxis", "ones", "random", "save",
                  "utils", "waitall", "zeros"} | set(ops_optimizer.__all__)
                 | set(_registry))
