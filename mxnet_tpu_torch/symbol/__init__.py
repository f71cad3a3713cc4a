"""``mx.sym``: graphs over the op registry, bound into Executors.

Counterpart of ``mxnet_tpu/symbol/``: ``Symbol``, ``var``/``Variable``,
``Group``, ``load``/``load_json`` and one frontend per registry op
(``mx.sym.FullyConnected``, ``mx.sym.split``, ...) and ``sym.random``
(draws as graph nodes); ``sym.contrib`` holds the ``_contrib_*`` ops by
their short names and the control-flow constructors ``foreach``,
``while_loop`` and ``cond``.
"""
import sys as _sys

from . import contrib, random  # noqa: F401  (mx.sym.contrib, .random)
from .executor import Executor
from .register import _attach_frontends
from .symbol import Group, Symbol, Variable, load, load_json, var

from ..ndarray.register import register_input_type  # noqa: E402

register_input_type(Symbol)
_attach_frontends(_sys.modules[__name__])

# the fluent methods, as ``NDArray``'s (the list lives in ``ndarray``)
from ..ndarray import _attach_symbol_fluent  # noqa: E402

_attach_symbol_fluent()

__all__ = ["Executor", "Group", "Symbol", "Variable", "contrib", "load",
           "load_json", "random", "var"]
