"""Automatic mixed precision (reference: python/mxnet/contrib/amp/amp.py).

Counterpart of ``mxnet_tpu/contrib/amp/amp.py`` (``init``/``disable``/
``active``, ``init_trainer``, ``scale_loss``, ``unscale``,
``convert_symbol``, ``convert_model`` and ``convert_hybrid_block``).  The JAX package inserts casts through a hook on
its single op-dispatch funnel; the port has no such funnel, so each op
function of the port whose name is in :mod:`.lists` calls :func:`cast` on
its inputs, and that one helper holds the policy:

- an ``LP16_OPS`` op casts its floating inputs to the target dtype;
- an ``FP32_OPS`` op casts them to float32;
- a ``WIDEST_TYPE_CASTS`` op casts them to float32 when float32 is among
  its input dtypes and they are not all one dtype;
- any other op, and every integer input, is left alone.

The casts are ordinary torch ops, recorded by autograd: the gradient of an
fp32 weight reaches it in fp32 through its cast.  ``torch.autocast`` is
not used: its op lists are not these, and its CPU and CUDA policies
differ, so the policy tested on the CPU would not be the one that runs on
the card.  The ops with a cast point are ``FullyConnected`` (``Dense``),
``Convolution`` (``Conv2D``), ``batch_dot`` and ``softmax`` (the
transformer's masked-softmax path), ``LayerNorm`` and the ``nd`` ops
``log_softmax``, ``sum`` and ``mean``.

Weights stay fp32 under AMP; for bf16/fp16 weights use ``Block.cast``
with ``Trainer(..., {"multi_precision": True})`` (MXNet's recipe).  Under
``init("float16")`` the flash kernel takes fp16 q/k/v on the card, and
``init_trainer``'s ``DynamicLossScaler`` (initial scale 2**16) with
``scale_loss`` and ``unscale`` skips a step whose gradients overflowed
and halves the scale.

``convert_symbol`` rewrites a Symbol for inference in low precision, as
MXNet 1.x's does: every input of an ``LP16_OPS`` node passes through an
``amp_cast`` to the target dtype (a node ``{input}_amp_lp``), every input
of an ``FP32_OPS`` node through one to float32 (``{input}_amp_f32``), and
the inputs of a ``WIDEST_TYPE_CASTS`` node with more than one input
through one ``amp_multicast`` (``{node}_amp_widest``) to their widest
dtype; nodes named in ``excluded_sym_names`` keep their inputs.  The node
names and order are the JAX package's (:140-186), so one Symbol converts
to the same graph in both packages.  ``convert_model`` converts the
symbol and keeps the fp32 parameters as they are: the casts make the
low-precision copies at each forward.  Process-wide AMP is not involved:
a converted graph casts through its own nodes.
"""
from __future__ import annotations

import contextlib
import threading
from typing import List, Optional

import torch

from ... import autograd
from ...base import MXNetError
from . import lists
from .loss_scaler import DynamicLossScaler

__all__ = ["init", "disable", "active", "cast", "init_trainer",
           "scale_loss", "unscale", "convert_symbol", "convert_model",
           "convert_hybrid_block"]

_TARGETS = {"bfloat16": torch.bfloat16, "float16": torch.float16}
_LP16 = frozenset(lists.LP16_OPS)
_FP32 = frozenset(lists.FP32_OPS)
_WIDEST = frozenset(lists.WIDEST_TYPE_CASTS)

_state = {"active": False, "target_dtype": None}
_scope = threading.local()        # convert_hybrid_block's per-call target


def _check_target(target_dtype: str) -> None:
    if target_dtype not in _TARGETS:
        raise MXNetError("target_dtype must be 'bfloat16' or 'float16'")


def init(target_dtype: str = "bfloat16") -> None:
    """Turn on AMP process-wide (reference: amp.init()).  Call before
    building the network, as the reference requires."""
    _check_target(target_dtype)
    _state["active"] = True
    _state["target_dtype"] = target_dtype


def disable() -> None:
    """Turn AMP back off (test hook; no reference analog)."""
    _state["active"] = False
    _state["target_dtype"] = None


def active() -> bool:
    return _state["active"]


def _target() -> Optional[torch.dtype]:
    if _state["active"]:
        return _TARGETS[_state["target_dtype"]]
    return getattr(_scope, "target", None)


def _floating(t) -> bool:
    return isinstance(t, torch.Tensor) and t.is_floating_point()


def cast(op_name: str, *inputs) -> tuple:
    """``inputs`` of the op ``op_name`` cast by the AMP policy (see the
    module docstring), as a tuple; unchanged while AMP is off.  None and
    integer tensors pass through."""
    target = _target()
    if target is None:
        return inputs
    if op_name in _LP16:
        dtype = target
    elif op_name in _FP32:
        dtype = torch.float32
    elif op_name in _WIDEST:
        dtypes = {t.dtype for t in inputs if _floating(t)}
        if torch.float32 not in dtypes or len(dtypes) < 2:
            return inputs
        dtype = torch.float32
    else:
        return inputs
    return tuple(t.to(dtype) if _floating(t) else t for t in inputs)


def init_trainer(trainer, loss_scaler: Optional[DynamicLossScaler] = None):
    """Attach a dynamic loss scaler to a Gluon Trainer
    (reference: amp.init_trainer)."""
    trainer._amp_loss_scaler = loss_scaler or DynamicLossScaler()
    trainer._amp_original_scale = trainer._scale
    return trainer


def _scaler(trainer):
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None:
        raise MXNetError("call amp.init_trainer(trainer) first")
    return scaler


@contextlib.contextmanager
def scale_loss(loss, trainer):
    """``with amp.scale_loss(loss, trainer) as L: autograd.backward(L)``:
    multiplies the loss by the current scale and has ``trainer.step``
    divide the gradients by it (reference: amp.scale_loss).  The multiply
    is recorded even when ``scale_loss`` is entered outside ``record()``."""
    scaler = _scaler(trainer)
    trainer._scale = trainer._amp_original_scale / scaler.loss_scale
    with autograd.record():
        if isinstance(loss, (list, tuple)):
            scaled = [l * scaler.loss_scale for l in loss]
        else:
            scaled = loss * scaler.loss_scale
    yield scaled


def unscale(trainer) -> bool:
    """Check the gradients for overflow and update the scaler; True means
    the caller must skip ``trainer.step``.  Call between the backward and
    ``trainer.step``: after an overflow the gradients are marked stale,
    so the next backward's pass steps without a stale-gradient error (and
    a ``trainer.step`` before it raises one)."""
    scaler = _scaler(trainer)
    overflow = scaler.has_overflow(trainer._params)
    scaler.update_scale(overflow)
    if overflow:
        for p in trainer._params:
            p.fresh = True
    return overflow


def convert_symbol(sym, target_dtype: str = "bfloat16",
                   target_dtype_ops: Optional[List[str]] = None,
                   fp32_ops: Optional[List[str]] = None,
                   widest_dtype_ops: Optional[List[str]] = None,
                   excluded_sym_names: Optional[List[str]] = None):
    """``sym`` with ``amp_cast``/``amp_multicast`` nodes inserted
    (reference: amp.convert_symbol; see the module docstring).  The op
    lists default to :mod:`.lists`."""
    from ...symbol.symbol import Symbol, _Node
    _check_target(target_dtype)
    lp16 = _LP16 if target_dtype_ops is None else set(target_dtype_ops)
    fp32 = _FP32 if fp32_ops is None else set(fp32_ops)
    widest = _WIDEST if widest_dtype_ops is None else set(widest_dtype_ops)
    excluded = set(excluded_sym_names or ())

    def casted(entry, dtype, tag):
        node, idx = entry
        return (_Node("amp_cast", f"{node.name}_amp_{tag}", {"dtype": dtype},
                      [(node, idx)]), 0)

    mapping = {}
    for node in sym._topo():
        if node.is_var:
            mapping[id(node)] = node
            continue
        inputs = [(mapping[id(p)], i) for p, i in node.inputs]
        if node.name not in excluded:
            if node.op in lp16:
                inputs = [casted(e, target_dtype, "lp") for e in inputs]
            elif node.op in fp32:
                inputs = [casted(e, "float32", "f32") for e in inputs]
            elif node.op in widest and len(inputs) > 1:
                multi = _Node("amp_multicast", f"{node.name}_amp_widest",
                              {"num_outputs": len(inputs)}, inputs,
                              num_outputs=len(inputs))
                inputs = [(multi, i) for i in range(len(inputs))]
        mapping[id(node)] = _Node(node.op, node.name, dict(node.attrs),
                                  inputs, node.num_outputs)
    return Symbol([(mapping[id(n)], i) for n, i in sym._heads])


def convert_model(sym, arg_params, aux_params,
                  target_dtype: str = "bfloat16", **kwargs):
    """``(convert_symbol(sym, ...), arg_params, aux_params)``: a
    Module-style checkpoint for low-precision inference (reference:
    amp.convert_model), its parameters kept fp32 as masters."""
    return convert_symbol(sym, target_dtype, **kwargs), arg_params, \
        aux_params


@contextlib.contextmanager
def _scoped(target_dtype: str):
    """AMP for this thread for the duration of one call."""
    prev = getattr(_scope, "target", None)
    _scope.target = _TARGETS[target_dtype]
    try:
        yield
    finally:
        _scope.target = prev


def convert_hybrid_block(block, target_dtype: str = "bfloat16"):
    """Mixed precision for ONE block (reference: amp.convert_hybrid_block):
    its forward runs under the cast policy; other models keep full
    precision."""
    _check_target(target_dtype)
    inner = block.forward

    def amp_forward(*args, **kwargs):
        if _state["active"]:          # process-wide AMP already covers it
            return inner(*args, **kwargs)
        with _scoped(target_dtype):
            return inner(*args, **kwargs)

    block.forward = amp_forward       # instance attr shadows class method
    block.hybridize()
    return block
