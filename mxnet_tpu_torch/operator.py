"""Custom operators written in Python: ``CustomOp``, ``CustomOpProp``,
``register``.

Counterpart of ``mxnet_tpu/operator.py`` (:26-122), MXNet's custom-op
surface.  A ``CustomOpProp`` subclass describes an op (arguments, outputs,
shapes, dtypes, ``need_top_grad``) and makes its operator; ``register``
files it under a name; ``Custom(*inputs, op_type=name, **kwargs)`` (the
same function as ``mx.nd.Custom``, ``ndarray/ops_custom.py``) runs it.  The
operator's ``forward``/``backward`` receive tensors and write their
results with ``assign``.  Its callbacks may launch kernels compiled at run
time (``mxnet_tpu_torch.rtc``).
"""
from __future__ import annotations

from typing import Callable, List

import torch

from .base import MXNetError
from .ndarray.ops_custom import Custom, _registry

__all__ = ["CustomOp", "CustomOpProp", "register", "get_all_registered",
           "Custom"]


class CustomOp:
    """The user's operator: ``forward`` and ``backward`` write their
    outputs with :meth:`assign`."""

    def assign(self, dst: torch.Tensor, req: str, src) -> None:
        """Write ``src`` into ``dst`` as ``req`` asks: ``"write"`` and
        ``"inplace"`` overwrite, ``"add"`` accumulates, ``"null"`` (or
        None) leaves ``dst`` alone."""
        if req in ("null", None):
            return
        src = torch.as_tensor(src, device=dst.device)
        if req == "add":
            dst.add_(src)
        elif req in ("write", "inplace"):
            dst.copy_(src)
        else:
            raise MXNetError(f"assign: unknown req {req!r}")

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError


class CustomOpProp:
    """Metadata of a custom op and the factory of its operator.  The
    defaults: one argument ``data``, one output ``output`` of the
    argument's shape and dtype, no auxiliary state."""

    def __init__(self, need_top_grad: bool = True):
        self.need_top_grad_ = need_top_grad

    def list_arguments(self) -> List[str]:
        return ["data"]

    def list_outputs(self) -> List[str]:
        return ["output"]

    def list_auxiliary_states(self) -> List[str]:
        return []

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]], []

    def infer_type(self, in_type):
        return in_type, [in_type[0]], []

    def create_operator(self, ctx, in_shapes, in_dtypes) -> CustomOp:
        raise NotImplementedError


def register(reg_name: str) -> Callable[[type], type]:
    """Class decorator: file a ``CustomOpProp`` subclass under
    ``op_type=reg_name``."""
    def do(prop_cls: type) -> type:
        if not (isinstance(prop_cls, type)
                and issubclass(prop_cls, CustomOpProp)):
            raise MXNetError("register() expects a CustomOpProp subclass")
        _registry[reg_name] = prop_cls
        return prop_cls
    return do


def get_all_registered() -> List[str]:
    return sorted(_registry)
