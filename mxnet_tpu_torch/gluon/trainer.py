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
the first step, as MXNet expects).  ``optimizer_params`` go to the
optimizer as they are, ``lr_scheduler`` and ``begin_num_update``
included.

``kvstore`` takes a type name (``"device"``, ``"local"``, ``"nccl"``,
``"dist_sync"``, ``"dist_device_sync"``, ``"dist"``), None or a
``KVStore`` (the reference's ``_init_kvstore``, :73-102).  On a local
store ``update_on_kvstore`` None or False keeps the local update, True
runs the optimizer through the store's updater: at the first step the
store takes the optimizer and a copy of each weight, and each step pushes
the gradients and pulls the updated weights back.  On a distributed store
(more than one process) ``update_on_kvstore`` defaults to True, and the
first step broadcasts rank 0's weights through the store, so every
process starts equal:

- with ``update_on_kvstore`` each step pushes every live gradient in one
  call (one coalesced all-reduce across the processes), each process
  applies the same update to the same sum, and the weights are pulled
  back;
- without it ``allreduce_grads`` pushes every gradient in one call and
  pulls the sums back into the gradients, and ``update`` runs the local
  update on them (the multi-tensor SGD kernels, 41 launches a ResNet-50
  step).

``compression_params`` (2-bit, error feedback) applies to distributed
stores only: on a local one it warns and is ignored, as in the reference.
``allreduce_and_update`` is ``step``.  BatchNorm statistics stay per
process on this path, as MXNet and the JAX package's imperative path keep
them (``parallel.ShardedTrainer`` computes them over the global batch).

``save_states``/``load_states`` write and read the JAX package's pickle,
``{"states": {str(index): numpy tuples}, "num_update",
"index_update_count"}``, so a file of either package loads in the
other; the port adds ``optimizer_extra`` where the optimizer has one
(Nadam's momentum schedule), which the JAX loader ignores, so that a
resumed run equals the uninterrupted one.  Loaded states go onto each
parameter's device in the dtype a fresh state would have.  With
``update_on_kvstore`` the kvstore saves and loads its updater's states
instead (``Updater.get_states(dump_optimizer=True)``).

Under ``contrib.amp`` the Trainer carries the loss scaler
(``amp.init_trainer``), the scale ``update`` divides gradients by
(``_scale``, which ``amp.scale_loss`` divides by the loss scale).  When
``amp.unscale`` reports an overflow, the caller skips ``step``: the
gradients are stale by then, and a ``step`` raises on them as above.
"""
from __future__ import annotations

import pickle
import warnings
from typing import Dict, List

import torch

from .. import kvstore as kv_mod
from .. import optimizer as opt_mod
from ..base import MXNetError
from ..ndarray.ndarray import NDArray
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise MXNetError("params must be a ParameterDict or list")
        self._all_params = list(params)
        self._params: List[Parameter] = [
            p for p in params if p.grad_req != "null"]
        param_dict = dict(enumerate(self._params))
        self._optimizer = opt_mod.create(optimizer, param_dict=param_dict,
                                         **(optimizer_params or {}))
        self._scale = self._optimizer.rescale_grad
        self._kvstore = kv_mod.create(kvstore) if isinstance(kvstore, str) \
            else kvstore
        if compression_params is not None and self._kvstore is not None:
            if getattr(self._kvstore, "_dist", False):
                self._kvstore.set_gradient_compression(compression_params)
            else:
                warnings.warn("gradient compression applies to dist_* "
                              "kvstores only; ignored for the local store")
        # None: decided at the first step (True on a distributed store)
        self._update_on_kvstore = update_on_kvstore
        if self._update_on_kvstore and self._kvstore is None:
            raise MXNetError("update_on_kvstore=True requires a kvstore")
        self._dist_kv = False
        self._kv_initialized = False
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

    def _init_kvstore(self) -> None:
        """Decide the update path, once: with ``update_on_kvstore`` hand
        the store the optimizer and a copy of every weight; on a
        distributed store without it, take rank 0's weights through the
        store."""
        if self._kv_initialized:
            return
        kv = self._kvstore
        self._dist_kv = kv is not None and getattr(kv, "_dist", False)
        if self._update_on_kvstore is None:
            self._update_on_kvstore = self._dist_kv
        keys = list(range(len(self._params)))
        weights = [NDArray(p._tensor().detach()) for p in self._params]
        if self._update_on_kvstore:
            kv.set_optimizer(self._optimizer)
            kv.init(keys, weights)
        elif self._dist_kv:
            kv.init(keys, weights)
            for i, w in zip(keys, weights):
                kv.pull(i, out=w)
        self._kv_initialized = True

    def _live(self, ignore_stale_grad: bool):
        """``(index, parameter)`` of every parameter to update: a stale
        ``write`` gradient raises, or is skipped."""
        for i, param in enumerate(self._params):
            if param.grad_req == "write" and param.fresh:
                if not ignore_stale_grad:
                    raise MXNetError(
                        f"gradient of Parameter {param.name!r} has not "
                        f"been updated by backward since the last step; "
                        f"set ignore_stale_grad=True to skip such "
                        f"parameters")
                continue
            yield i, param

    def step(self, batch_size: int, ignore_stale_grad: bool = False) -> None:
        """Rescale gradients by ``1 / batch_size`` and update."""
        self._init_kvstore()
        if self._update_on_kvstore:
            self._optimizer.rescale_grad = self._scale / batch_size
            live = list(self._live(ignore_stale_grad))
            keys = [i for i, _ in live]
            if keys:
                self._kvstore.push(keys, [NDArray(p._grad_tensor())
                                          for _, p in live])
            for i, param in live:
                self._kvstore.pull(i, out=NDArray(param._tensor().detach()))
                param.fresh = True
            return
        self.allreduce_grads()
        self.update(batch_size, ignore_stale_grad)

    def allreduce_grads(self) -> None:
        """Sum the gradients across the processes of a distributed store:
        one push of every gradient (one coalesced collective), the sums
        pulled back into the gradients.  One process: nothing to do."""
        self._init_kvstore()
        if self._update_on_kvstore:
            raise MXNetError(
                "allreduce_grads is not applicable when the optimizer runs "
                "on the kvstore (update_on_kvstore=True)")
        if not self._dist_kv:
            return
        grads = [NDArray(p._grad_tensor()) for p in self._params]
        keys = list(range(len(grads)))
        self._kvstore.push(keys, grads)
        for i, g in zip(keys, grads):
            self._kvstore.pull(i, out=g)

    def allreduce_and_update(self, batch_size: int) -> None:
        self.step(batch_size)

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

        for i, param in self._live(ignore_stale_grad):
            data = param._tensor()
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
                group.append((i, data, param._grad_tensor(), self._states[i]))
                if len(group) >= agg:
                    flush()
            else:
                self._optimizer.update_multi_precision(
                    i, data, param._grad_tensor(), self._states[i])
            # the next backward writes a fresh gradient
            param.fresh = True
        flush()

    def save_states(self, fname: str) -> None:
        """Write the optimizer states and counts (see the module
        docstring)."""
        self._init_kvstore()
        if self._update_on_kvstore:
            self._kvstore.save_optimizer_states(fname, dump_optimizer=True)
            return
        blob = {"states": {str(i): opt_mod.states_to_np(s)
                           for i, s in self._states.items()},
                **opt_mod.optimizer_blob(self._optimizer)}
        with open(fname, "wb") as f:
            pickle.dump(blob, f)

    def load_states(self, fname: str) -> None:
        """Read a ``save_states`` file of either package: the counts, the
        optimizer's extra state where the file has one, and the state of
        every parameter it holds."""
        self._init_kvstore()
        if self._update_on_kvstore:
            self._kvstore.load_optimizer_states(fname)
            return
        with open(fname, "rb") as f:
            blob = pickle.load(f)
        self._optimizer.num_update = blob.get("num_update", 0)
        self._optimizer._index_update_count = dict(
            blob.get("index_update_count", {}))
        if "optimizer_extra" in blob:
            self._optimizer.set_extra_state(blob["optimizer_extra"])
        for i, param in enumerate(self._params):
            if str(i) not in blob["states"]:
                continue
            data = param._tensor()
            fresh = self._optimizer.create_state_multi_precision(i, data)
            self._states[i] = opt_mod.states_from_np(
                blob["states"][str(i)], data.device, fresh)
            self._state_dtypes[i] = data.dtype
