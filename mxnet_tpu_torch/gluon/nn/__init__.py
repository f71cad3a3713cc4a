"""Gluon layers (``gluon.nn``)."""
from .basic_layers import *  # noqa: F401,F403
from .basic_layers import __all__ as _basic
from .conv_layers import *  # noqa: F401,F403
from .conv_layers import __all__ as _conv

__all__ = sorted(_basic + _conv)
