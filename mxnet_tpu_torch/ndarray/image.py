"""``mx.nd.image``: the ``_image_*`` ops of ``ops_image.py`` by their
short names (counterpart of ``mxnet_tpu/ndarray/image.py``)."""
from __future__ import annotations

import sys as _sys

from .register import _registry, make_frontend

_PREFIX = "_image_"
_this_module = _sys.modules[__name__]

for _name, _op in list(_registry.items()):
    if _name.startswith(_PREFIX):
        setattr(_this_module, _name[len(_PREFIX):], make_frontend(_op))
