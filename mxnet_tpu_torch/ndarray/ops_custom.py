"""The ``Custom`` op: runs a registered ``CustomOpProp``'s operator on
tensors, inside torch's autograd graph.

Counterpart of ``mxnet_tpu/ndarray/ops_custom.py`` (:26-128); exposed as
``mx.nd.Custom`` and as ``mx.operator.Custom`` (one function).  MXNet's
``custom.cc`` ran the user's Python callbacks on an engine thread; here
they run inline, as the JAX package's eager path does.  Semantics:

- output shapes from ``infer_shape``, output dtypes from ``infer_type``;
  where ``infer_type`` raises ``NotImplementedError`` or ``IndexError``,
  every output takes the first input's dtype (float32 for a source op
  without inputs);
- one operator instance per call (``create_operator``), shared by the
  forward and the backward callbacks: state the op keeps on ``self`` in
  ``forward`` is there in ``backward``;
- both callbacks run under ``autograd.pause()``; ``req`` is ``"write"``
  for every output and every input gradient; ``is_train`` is
  ``autograd.is_training()`` at the call;
- outputs are allocated as zeros on the inputs' device (``ctx`` for a
  source op); one output comes back as a tensor, several as a tuple;
- the call is one node of torch's graph (``autograd.Function``): inside
  ``autograd.record()`` its input gradients reach ``autograd.backward``
  and the Parameters like a built-in op's.  An output that no head
  reached gets a zero gradient, as in MXNet.

On ``NDArray`` inputs the op runs on their tensors and returns
``NDArray``s (``register.boundary``).  The user's operator sees
``in_data``, ``out_data``, ``out_grad`` and ``in_grad`` as ``NDArray``s
over the tensors of the call, as MXNet's and the JAX package's do
(``mxnet_tpu/operator.py:92-128``): ``assign`` into one writes the
output or the gradient, and ``nd`` ops and ``rtc`` launches take them.

The registry of props (``register`` in ``mxnet_tpu_torch/operator.py``
fills it) lives here, beside the op that looks names up in it.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from .. import autograd
from ..base import MXNetError, torch_dtype
from ..context import DeviceLike, as_device
from .ndarray import NDArray
from .register import boundary, register_op

__all__ = ["Custom"]

_registry: Dict[str, type] = {}


def _out_dtypes(prop, in_dtypes: List[torch.dtype],
                n_out: int) -> List[torch.dtype]:
    default = in_dtypes[0] if in_dtypes else torch.float32
    try:
        _, out_types, _ = prop.infer_type(list(in_dtypes))
    except (NotImplementedError, IndexError):
        out_types = []
    return [torch_dtype(out_types[i])
            if i < len(out_types) and out_types[i] is not None else default
            for i in range(n_out)]


def _wrap(tensors) -> List[NDArray]:
    """The user's view of a callback's arrays: ``NDArray``s over the
    tensors themselves, so what the op writes lands in them."""
    return [NDArray(t) for t in tensors]


class _CustomNode(autograd.Function):
    """One call of a custom op: the user's operator between torch's
    forward and backward."""

    def __init__(self, op, out_specs, is_train: bool, device):
        super().__init__()
        self._op = op
        self._out_specs = out_specs
        self._is_train = is_train
        self._device = device
        self._n_in = 0

    def forward(self, *ins):
        outs = [torch.zeros(shape, dtype=dt, device=self._device)
                for shape, dt in self._out_specs]
        self._op.forward(is_train=self._is_train, req=["write"] * len(outs),
                         in_data=_wrap(ins), out_data=_wrap(outs), aux=[])
        self.save_for_backward(*ins, *outs)
        self._n_in = len(ins)
        return tuple(outs) if len(outs) > 1 else outs[0]

    def backward(self, *out_grads):
        ins = list(self.saved_tensors[:self._n_in])
        outs = list(self.saved_tensors[self._n_in:])
        in_grads = [torch.zeros_like(x) for x in ins]
        self._op.backward(req=["write"] * len(in_grads),
                          out_grad=_wrap(out_grads), in_data=_wrap(ins),
                          out_data=_wrap(outs), in_grad=_wrap(in_grads),
                          aux=[])
        return tuple(in_grads)


@boundary
def Custom(*inputs: torch.Tensor, op_type: Optional[str] = None,
           ctx: DeviceLike = None, **kwargs):
    """Run the custom op registered as ``op_type`` on ``inputs`` (tensors
    on one device); ``kwargs`` go to the prop's constructor.  ``ctx`` is
    the device of a source op's outputs (no inputs; default ``gpu(0)``)."""
    if op_type not in _registry:
        raise MXNetError(f"unknown custom op_type {op_type!r}; registered: "
                         f"{sorted(_registry)}")
    for x in inputs:
        if not isinstance(x, torch.Tensor):
            raise MXNetError(f"Custom[{op_type}]: inputs must be tensors, "
                             f"got {type(x).__name__}")
    devices = {x.device for x in inputs}
    if len(devices) > 1:
        raise MXNetError(f"Custom[{op_type}]: inputs on "
                         f"{sorted(map(str, devices))}")
    device = inputs[0].device if inputs else as_device(ctx)
    prop = _registry[op_type](**kwargs)
    in_shapes = [list(x.shape) for x in inputs]
    in_dtypes = [x.dtype for x in inputs]
    _, out_shapes, _ = prop.infer_shape(in_shapes)
    out_specs = list(zip([tuple(s) for s in out_shapes],
                         _out_dtypes(prop, in_dtypes, len(out_shapes))))
    op = prop.create_operator(device, in_shapes, in_dtypes)
    return _CustomNode(op, out_specs, autograd.is_training(), device)(*inputs)


def _custom_maker(**kwargs):
    """The registry's ``Custom`` (the JAX package's
    ``mxnet_tpu/ndarray/ops_custom.py:128``): the frontend above on the
    op's tensors, ``op_type`` and the prop's arguments as parameters."""
    def fn(*tensors):
        return Custom(*tensors, **kwargs)
    return fn


register_op("Custom", _custom_maker)
