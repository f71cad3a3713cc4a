"""``mx.name``: ``NameManager`` and ``Prefix``, the scopes of a Symbol's
automatic node names.

Counterpart of ``mxnet_tpu/name.py``: ``mx.sym``'s node naming asks the
innermost manager of this thread (``current()``), so ``with
mx.name.Prefix("stage1_"):`` puts ``stage1_`` before every name made
inside the scope; a name the caller gives is never prefixed.
"""
from __future__ import annotations

import threading
from typing import Optional

__all__ = ["NameManager", "Prefix", "current"]

_state = threading.local()


def _stack() -> list:
    stack = getattr(_state, "stack", None)
    if not stack:
        stack = _state.stack = [NameManager()]
    return stack


def current() -> "NameManager":
    return _stack()[-1]


class NameManager:
    """The default manager: ``{hint}{counter}`` names, one counter per
    hint for the process (``symbol._auto_name``)."""

    def get(self, name: Optional[str], hint: str) -> str:
        if name is not None:
            return name
        from .symbol.symbol import _auto_name
        return _auto_name(hint)

    def __enter__(self):
        _stack().append(self)
        return self

    def __exit__(self, *exc):
        _stack().pop()


class Prefix(NameManager):
    """Puts ``prefix`` before every automatic name in the scope."""

    def __init__(self, prefix: str):
        self._prefix = prefix

    def get(self, name: Optional[str], hint: str) -> str:
        if name is not None:
            return name
        return self._prefix + super().get(None, hint)
