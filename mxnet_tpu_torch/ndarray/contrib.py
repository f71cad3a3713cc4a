"""``mx.nd.contrib``: the frontends of the ``_contrib_*`` ops, by the name
after the prefix (``nd.contrib.MultiBoxTarget``, ``nd.contrib.box_nms``).

Counterpart of the generated part of ``mxnet_tpu/ndarray/contrib.py``
(its control-flow operators are not ported).
"""
from __future__ import annotations

import sys as _sys

from .register import _registry, make_frontend

_PREFIX = "_contrib_"
_mod = _sys.modules[__name__]

for _name, _op in list(_registry.items()):
    if _name.startswith(_PREFIX):
        setattr(_mod, _name[len(_PREFIX):], make_frontend(_op))
