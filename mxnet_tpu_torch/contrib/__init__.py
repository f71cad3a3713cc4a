"""Contributed modules (``mx.contrib``): automatic mixed precision and
int8 quantization."""
from . import amp, quantization

__all__ = ["amp", "quantization"]
