"""Gluon Trainer: applies an optimizer to Parameters.

Counterpart of ``mxnet_tpu/gluon/trainer.py`` for one device: ``step`` is
``allreduce_grads`` (nothing to reduce: each Parameter has one copy) and
``update``.  ``update`` keeps the reference's aggregation loop and flush
order: with an optimizer that has ``update_multi`` and
``aggregate_num > 1`` (SGD: ``MXNET_OPTIMIZER_AGGREGATION_SIZE``, default
4), trainable parameters are grouped in order, ``aggregate_num`` at a time,
into one multi-tensor update each, and the last partial group is flushed
at the end.  ResNet-50's 161 trainable parameters thus make 41 updates per
step, each one launch of the momentum kernel on the card.

A ``write`` gradient that no backward has written since the last step is
stale: ``step`` raises on it, or skips the parameter with
``ignore_stale_grad=True``.  The optimizer state of a parameter is made
at its first update, for the weight's dtype then (with
``multi_precision``, fp32 masters for bf16/fp16 weights); a parameter
cast to another dtype after that raises at the next step (cast before
the first step, as MXNet expects).

``kvstore`` takes ``"device"``, ``"local"`` or None, all the same on one
device; the distributed kvstores are not ported.

Under ``contrib.amp`` the Trainer carries the loss scaler
(``amp.init_trainer``), the scale ``update`` divides gradients by
(``_scale``, which ``amp.scale_loss`` divides by the loss scale).  When
``amp.unscale`` reports an overflow, the caller skips ``step``: the
gradients are stale by then, and a ``step`` raises on them as above.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from .. import optimizer as opt_mod
from ..base import MXNetError
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]

_KVSTORES = ("device", "local", None)


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device"):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise MXNetError("params must be a ParameterDict or list")
        if kvstore not in _KVSTORES:
            raise MXNetError(f"kvstore {kvstore!r}: the port takes "
                             f"{_KVSTORES} (no distributed kvstore yet)")
        self._params: List[Parameter] = [
            p for p in params if p.grad_req != "null"]
        param_dict = dict(enumerate(self._params))
        self._optimizer = opt_mod.create(optimizer, param_dict=param_dict,
                                         **(optimizer_params or {}))
        self._scale = self._optimizer.rescale_grad
        self._states: Dict[int, object] = {}
        self._state_dtypes: Dict[int, torch.dtype] = {}
        # contrib.amp: init_trainer sets the scaler and the unscaled
        # ``_scale``; scale_loss divides ``_scale`` by the loss scale
        self._amp_loss_scaler = None
        self._amp_original_scale = self._scale

    @property
    def learning_rate(self) -> float:
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr: float) -> None:
        self._optimizer.set_learning_rate(lr)

    def step(self, batch_size: int, ignore_stale_grad: bool = False) -> None:
        """Rescale gradients by ``1 / batch_size`` and update."""
        self.allreduce_grads()
        self.update(batch_size, ignore_stale_grad)

    def allreduce_grads(self) -> None:
        """Sum gradients across device replicas: one device, nothing to
        do."""

    @torch.no_grad()
    def update(self, batch_size: int, ignore_stale_grad: bool = False) -> None:
        self._optimizer.rescale_grad = self._scale / batch_size
        agg = getattr(self._optimizer, "aggregate_num", 0)
        use_multi = agg > 1 and hasattr(self._optimizer, "update_multi")
        group: List = []   # pending (index, data, grad, state) tuples

        def flush():
            if not group:
                return
            idx, datas, grads, sts = zip(*group)
            self._optimizer.update_multi(list(idx), list(datas),
                                         list(grads), list(sts))
            group.clear()

        for i, param in enumerate(self._params):
            if param.grad_req == "write" and param.fresh:
                if not ignore_stale_grad:
                    raise MXNetError(
                        f"gradient of Parameter {param.name!r} has not "
                        f"been updated by backward since the last step; "
                        f"set ignore_stale_grad=True to skip such "
                        f"parameters")
                continue
            data = param.data()
            if i not in self._states:
                self._states[i] = \
                    self._optimizer.create_state_multi_precision(i, data)
                self._state_dtypes[i] = data.dtype
            elif self._state_dtypes.get(i, data.dtype) != data.dtype:
                raise MXNetError(
                    f"Parameter {param.name!r} is {data.dtype}, but its "
                    f"optimizer state was made for "
                    f"{self._state_dtypes[i]}: cast before the first step")
            if use_multi:
                group.append((i, data, param.grad(), self._states[i]))
                if len(group) >= agg:
                    flush()
            else:
                self._optimizer.update_multi_precision(
                    i, data, param.grad(), self._states[i])
            # the next backward writes a fresh gradient
            param.fresh = True
        flush()
