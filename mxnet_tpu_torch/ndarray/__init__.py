"""``mx.nd``: ``NDArray``, the operator frontends and array creation.

Counterpart of ``mxnet_tpu/ndarray/__init__.py``.  The frontends are made
from the op registry (``register.make_frontend``) for every op the
``ops_*`` modules register; each takes ``NDArray``s (and returns them)
or tensors (and returns tensors), see ``register.py``.  The fluent
methods (``x.sum(axis)``, ``x.exp()``, ``x.transpose()``, ...) delegate
to the frontends with the array as first input (``_FLUENT_METHODS`` :57,
``_attach_fluent`` :71).  Hand-written frontends: the optimizer updates
(``ops_optimizer.py``; in place on tensors, MXNet's convention on
``NDArray``s), ``Custom`` (``ops_custom.py``),
``flash_attention`` (``ops_contrib.py``), the draws of ``nd.random``,
``waitall``, ``save`` and ``load``.  ``nd.contrib`` holds the
``_contrib_*`` ops by their short names (the detection ops of
``ops_contrib.py``), ``nd.image`` the ``_image_*`` ops
(``ops_image.py``).
"""
import sys as _sys

from . import (ops_contrib, ops_elemwise, ops_image,  # noqa: F401
               ops_matrix, ops_nn, ops_optimizer, ops_random, ops_reduce)
from . import contrib, image, random, utils
from .ndarray import (NDArray, arange, array, empty, eye, full, linspace,
                      ones, zeros)
from .ops_contrib import flash_attention
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
from .register import _registry, get_op, list_ops, make_frontend
from .utils import load, save

_this = _sys.modules[__name__]
for _name, _op in list(_registry.items()):
    if not hasattr(_this, _name):
        setattr(_this, _name, make_frontend(_op))
# the optimizer updates by their ``_contrib_`` names: the hand-written
# frontends (in place on tensors), as under their short names
for _name in ("group_adagrad_update", "adamw_update", "mp_adamw_update"):
    setattr(_this, "_contrib_" + _name, getattr(_this, _name))
    setattr(contrib, _name, getattr(_this, _name))

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
    "log_softmax", "zeros_like", "ones_like")


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


def waitall() -> None:
    """Block until every op queued on every device has run."""
    from ..engine import wait_all
    wait_all()


__all__ = sorted({"Custom", "NDArray", "arange", "array", "contrib",
                  "empty", "eye", "flash_attention", "full", "get_op",
                  "linspace", "list_ops", "load", "ones", "random", "save",
                  "utils", "waitall", "zeros"} | set(ops_optimizer.__all__)
                 | set(_registry))
