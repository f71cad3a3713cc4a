"""``mx.AttrScope``: attributes stamped on every Symbol node (variables
too) made inside the ``with`` block.

Counterpart of ``mxnet_tpu/attribute.py``.  A scope's ``key=value`` (both
strings) lands on a node as ``__key__``, the metadata form that is never
passed to the op (``Symbol.attr("key")`` reads it back); nested scopes
merge, the inner value winning.  The keys of the variables' own metadata
(``shape``, ``dtype``, ``aux``, ``init``, ``layout``) are refused.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

__all__ = ["AttrScope", "current"]

_state = threading.local()


def _stack() -> list:
    stack = getattr(_state, "stack", None)
    if not stack:
        stack = _state.stack = [AttrScope()]
    return stack


def current() -> "AttrScope":
    return _stack()[-1]


class AttrScope:
    _RESERVED = ("shape", "dtype", "aux", "init", "layout")

    def __init__(self, **kwargs):
        for k, v in kwargs.items():
            if not isinstance(v, str):
                raise ValueError("AttrScope values must be strings")
            if k in self._RESERVED or (k.startswith("__")
                                       and k.endswith("__")):
                raise ValueError(f"AttrScope key {k!r} is reserved for "
                                 f"the variables' metadata")
        self._attrs: Dict[str, str] = dict(kwargs)

    def get(self, attrs: Optional[Dict] = None) -> Dict:
        """The scope's attributes as ``__key__`` entries, under those
        given."""
        out = {f"__{k}__": v for k, v in self._attrs.items()}
        if attrs:
            out.update(attrs)
        return out

    def __enter__(self):
        stack = _stack()
        scope = AttrScope()
        scope._attrs = {**stack[-1]._attrs, **self._attrs}
        stack.append(scope)
        return self

    def __exit__(self, *exc):
        _stack().pop()
