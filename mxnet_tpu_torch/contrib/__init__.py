"""Contributed modules (``mx.contrib``): automatic mixed precision."""
from . import amp

__all__ = ["amp"]
