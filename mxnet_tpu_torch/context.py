"""Device contexts: ``cpu()``, ``gpu(i)`` and the ``with ctx:`` scope.

Counterpart of ``mxnet_tpu/context.py`` (:28-160).  A :class:`Context` is
a ``str`` that names a torch device (``"cpu"``, ``"cuda:0"``), so torch
takes it wherever it takes a device (``device=gpu(0)``, ``t.to(cpu())``,
``torch.device(ctx)``), and it carries MXNet's face besides:
``device_type`` ("cpu"/"gpu"), ``device_id``, ``repr`` ``gpu(0)``, and
``with mx.cpu():`` pushes it onto a thread-local stack that
``current_context()`` (and ``as_device(None)``) reads.  A context equals
the torch device it names.

The default context, with no scope open, is ``gpu(0)``: entry points run
on the first CUDA card unless the caller passes ``ctx=cpu()`` (or a device
string such as ``"cpu"``) or opens a ``with cpu():`` scope.  No path falls
back to the CPU when no card is found.
"""
from __future__ import annotations

import threading
from typing import Dict, Union

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "cpu_pinned", "gpu", "current_context", "as_device",
           "context_of", "num_gpus"]


class Context(str):
    """A device name torch accepts, with MXNet's context surface."""

    __slots__ = ()
    _scope = threading.local()

    def __new__(cls, device_type: str = "cpu", device_id: int = 0):
        if device_type in ("gpu", "cuda"):
            return super().__new__(cls, f"cuda:{int(device_id)}")
        if device_type in ("cpu", "cpu_pinned", "cpu_shared"):
            return super().__new__(cls, "cpu")
        raise MXNetError(f"unknown device type {device_type!r}")

    @property
    def device_type(self) -> str:
        return "gpu" if self[:4] == "cuda" else "cpu"

    @property
    def device_id(self) -> int:
        return int(self[5:]) if self[:4] == "cuda" else 0

    @property
    def type(self) -> str:
        """The torch device type (``"cpu"`` or ``"cuda"``)."""
        return "cuda" if self[:4] == "cuda" else "cpu"

    @property
    def index(self):
        return self.device_id if self[:4] == "cuda" else None

    @property
    def device(self) -> torch.device:
        return _DEVICES[self]

    def __repr__(self):
        return f"{self.device_type}({self.device_id})"

    def __eq__(self, other):
        if isinstance(other, (str, torch.device)):
            try:
                return torch.device(str(self)) == torch.device(other)
            except RuntimeError:
                return False
        return NotImplemented

    def __ne__(self, other):
        eq = self.__eq__(other)
        return eq if eq is NotImplemented else not eq

    def __hash__(self):
        return str.__hash__(self)

    def __enter__(self) -> "Context":
        _stack().append(self)
        return self

    def __exit__(self, *exc):
        _stack().pop()


def _stack():
    st = getattr(Context._scope, "stack", None)
    if st is None:
        st = Context._scope.stack = []
    return st


class _Devices(dict):
    """Context -> torch.device, filled on first use."""

    def __missing__(self, ctx):
        dev = self[ctx] = torch.device(str(ctx))
        return dev


_DEVICES: Dict[Context, torch.device] = _Devices()
_BY_DEVICE: Dict[torch.device, Context] = {}


def context_of(device: torch.device) -> Context:
    """The context of a torch device."""
    ctx = _BY_DEVICE.get(device)
    if ctx is None:
        ctx = _BY_DEVICE[device] = Context(
            device.type, device.index if device.index is not None else 0)
    return ctx


def cpu(device_id: int = 0) -> Context:
    return _CPU


def cpu_pinned(device_id: int = 0) -> Context:
    """MXNet's page-locked host context: the host (``cpu()``)."""
    return Context("cpu_pinned", device_id)


def gpu(device_id: int = 0) -> Context:
    return _GPU0 if device_id == 0 else Context("gpu", device_id)


_CPU = Context("cpu")
_GPU0 = Context("gpu", 0)

DeviceLike = Union[Context, torch.device, str, None]


def current_context() -> Context:
    """The innermost ``with ctx:`` scope of this thread, else ``gpu(0)``."""
    st = getattr(Context._scope, "stack", None)
    return st[-1] if st else _GPU0


def num_gpus() -> int:
    return torch.cuda.device_count()


def as_device(ctx: DeviceLike = None) -> torch.device:
    """Normalise a context argument to a ``torch.device``: None is the
    current context, a string names a torch device (``"cuda"`` is card
    0)."""
    if ctx is None:
        ctx = current_context()
    if isinstance(ctx, Context):
        return _DEVICES[ctx]
    dev = torch.device(ctx)
    if dev.type == "cuda" and dev.index is None:
        dev = _DEVICES[_GPU0]
    return dev
