"""Module: a Symbol bound on one context, its parameters and its
optimizer.

Counterpart of ``mxnet_tpu/module/module.py``.  ``context=None`` is the
current context (``gpu(0)`` unless a ``with cpu():`` scope is open).
The parameters, their gradients and the aux states are the executor's
own arrays on that context, named by the symbol's arguments that are not
data or labels; ``init_params`` fills them in place (from ``arg_params``
or, on the CPU from ``mx.random``'s CPU generator, from the initializer,
default ``Uniform(0.01)``, which honours a variable's ``__init__``
attribute) and ``get_params`` returns CPU copies.  A module bound with
``shared_module`` binds over that module's parameter, gradient and aux
arrays (the same tensors), which is how a ``BucketingModule``'s buckets
share one set.

``update`` goes per parameter, as the JAX package's: the gradient is
pushed to and pulled from the kvstore (``"local"`` by default, which
returns their sum over replicas, here the one gradient), then
``Updater(index, grad, weight)`` updates the weight in place.  The
optimizer is made with ``rescale_grad = 1 / batch size`` unless given;
``borrow_optimizer`` shares one optimizer and updater (one set of
states) between modules.  ``save_checkpoint``/``load`` write and read
``prefix-symbol.json``, ``prefix-%04d.params`` and, on request,
``prefix-%04d.states``.
"""
from __future__ import annotations

import logging
from typing import Dict, List, Optional, Sequence

import torch

from .. import kvstore as kv_mod
from .. import optimizer as opt_mod
from .. import random as _random
from ..base import MXNetError
from ..context import cpu, current_context
from ..initializer import InitDesc, Uniform
from ..io import DataDesc
from ..model import load_checkpoint, save_checkpoint
from ..ndarray import NDArray
from .base_module import BaseModule
from .executor_group import DataParallelExecutorGroup

__all__ = ["Module"]


def _descs(lst) -> List[DataDesc]:
    return [d if isinstance(d, DataDesc) else DataDesc(*d)
            for d in (lst or [])]


def _host_copy(arrays: Dict[str, NDArray]) -> Dict[str, NDArray]:
    return {k: NDArray(v._data.detach().to("cpu", copy=True))
            for k, v in arrays.items()}


class Module(BaseModule):
    def __init__(self, symbol, data_names: Sequence[str] = ("data",),
                 label_names: Sequence[str] = ("softmax_label",),
                 logger=logging, context=None, work_load_list=None,
                 fixed_param_names=None, state_names=None,
                 group2ctxs=None, compression_params=None):
        super().__init__(logger)
        if context is None:
            context = [current_context()]
        if isinstance(context, str):          # a Context is a str
            context = [context]
        self._context = list(context)
        self._symbol = symbol
        self._data_names = list(data_names)
        self._label_names = list(label_names or [])
        self._fixed_param_names = list(fixed_param_names or [])
        inputs = set(self._data_names) | set(self._label_names)
        self._param_names = [n for n in symbol.list_arguments()
                             if n not in inputs]
        self._aux_names = symbol.list_auxiliary_states()
        self._arg_params: Dict[str, NDArray] = {}
        self._grad_params: Dict[str, Optional[NDArray]] = {}
        self._aux_params: Dict[str, NDArray] = {}
        self._exec_group: Optional[DataParallelExecutorGroup] = None
        self._optimizer = None
        self._updater = None
        self._kvstore = None
        self._param_index: Dict[str, int] = {}
        self._data_shapes = None
        self._label_shapes = None
        self._preloaded = None
        self._preloaded_states = None

    # -- introspection -----------------------------------------------------
    @property
    def symbol(self):
        return self._symbol

    @property
    def data_names(self) -> List[str]:
        return self._data_names

    @property
    def label_names(self) -> List[str]:
        return self._label_names

    @property
    def output_names(self) -> List[str]:
        return self._symbol.list_outputs()

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return list(zip(self.output_names,
                        [o.shape for o in self.get_outputs()]))

    # -- bind --------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write") -> None:
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        self._data_shapes = _descs(data_shapes)
        self._label_shapes = _descs(label_shapes)
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        shared = None
        if shared_module is not None:
            if not shared_module.binded:
                raise MXNetError("shared_module must be bound first")
            shared = {n: (a, shared_module._grad_params.get(n))
                      for n, a in shared_module._arg_params.items()}
            shared.update({n: (a, None) for n, a in
                           shared_module._aux_params.items()})
        self._exec_group = DataParallelExecutorGroup(
            self._symbol, self._context, self._data_shapes,
            self._label_shapes, self._param_names, for_training,
            inputs_need_grad, self._fixed_param_names, grad_req, shared)
        exe = self._exec_group.execs[0]
        self._arg_params = {n: exe.arg_dict[n] for n in self._param_names}
        self._grad_params = {n: exe.grad_dict[n] for n in self._param_names}
        self._aux_params = exe.aux_dict
        self.binded = True
        if shared_module is not None:
            self.params_initialized = shared_module.params_initialized
        if self._preloaded is not None:
            arg, aux = self._preloaded
            self.init_params(arg_params=arg, aux_params=aux)
            self._preloaded = None

    # -- params ------------------------------------------------------------
    def init_params(self, initializer=None, arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False) -> None:
        if self.params_initialized and not force_init:
            return
        if not self.binded:
            raise MXNetError("init_params requires bind()")
        if initializer is None:
            initializer = Uniform(0.01)
        gen = _random.generator(cpu())
        attrs = self._symbol.attr_dict()
        given = [(self._arg_params, arg_params),
                 (self._aux_params, aux_params)]
        for (dst, src), kind in zip(given, ("parameter", "aux state")):
            if src and not allow_extra:
                extra = sorted(set(src) - set(dst))
                if extra:
                    raise MXNetError(f"unknown {kind}s {extra}")
            for name, arr in dst.items():
                with torch.no_grad():
                    if src and name in src:
                        val = src[name]
                        val = val._data if isinstance(val, NDArray) \
                            else torch.as_tensor(val)
                        arr._data.copy_(val)
                        continue
                    if src and not allow_missing:
                        raise MXNetError(f"missing {kind} {name!r}")
                    host = torch.empty(arr.shape, dtype=arr._data.dtype)
                    initializer(InitDesc(name, attrs.get(name, {})), host,
                                gen)
                    arr._data.copy_(host)
        self.params_initialized = True

    def get_params(self):
        """CPU copies of the parameters and the aux states."""
        return _host_copy(self._arg_params), _host_copy(self._aux_params)

    # -- optimizer ---------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=None, force_init=False) -> None:
        if not self.binded or not self.params_initialized:
            raise MXNetError("init_optimizer requires bind + init_params")
        if self.optimizer_initialized and not force_init:
            return
        optimizer_params = dict(optimizer_params or {})
        if isinstance(optimizer, str):
            optimizer_params.setdefault(
                "rescale_grad", 1.0 / self._data_shapes[0].shape[0])
            optimizer = opt_mod.create(
                optimizer, param_idx2name=dict(enumerate(self._param_names)),
                **optimizer_params)
        self._optimizer = optimizer
        self._updater = opt_mod.get_updater(optimizer)
        self._param_index = {n: i for i, n in enumerate(self._param_names)}
        if isinstance(kvstore, str):
            kvstore = kv_mod.create(kvstore) if kvstore else None
        self._kvstore = kvstore
        if kvstore is not None:
            for i, name in enumerate(self._param_names):
                kvstore.init(i, self._arg_params[name])
        if self._preloaded_states is not None:
            with open(self._preloaded_states, "rb") as f:
                self._updater.set_states(f.read(), self._context[0])
            self._preloaded_states = None
        self.optimizer_initialized = True

    def borrow_optimizer(self, shared_module: "Module") -> None:
        """Share ``shared_module``'s optimizer, updater and kvstore: one
        set of states whichever module updates."""
        if not shared_module.optimizer_initialized:
            raise MXNetError("shared module has no optimizer")
        self._optimizer = shared_module._optimizer
        self._updater = shared_module._updater
        self._kvstore = shared_module._kvstore
        self._param_index = shared_module._param_index
        self.optimizer_initialized = True

    # -- execution ---------------------------------------------------------
    def forward(self, data_batch, is_train=None) -> None:
        if not self.binded or not self.params_initialized:
            raise MXNetError("forward requires bind + init_params")
        self._exec_group.forward(data_batch, is_train)

    def backward(self, out_grads=None) -> None:
        self._exec_group.backward(out_grads)

    def update(self) -> None:
        """Per parameter: the kvstore's push and pull, then the updater
        (see the module docstring)."""
        if not self.optimizer_initialized:
            raise MXNetError("update requires init_optimizer")
        for name in self._param_names:
            i = self._param_index.get(name)
            grad = self._grad_params.get(name)
            if i is None or grad is None:
                continue
            if self._kvstore is not None:
                self._kvstore.push(i, [grad])
                grad = self._kvstore.pull(i)
            self._updater(i, grad, self._arg_params[name])

    def get_outputs(self, merge_multi_context=True):
        return self._exec_group.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True) -> List[NDArray]:
        """The gradients of the data inputs from the last backward (bound
        with ``inputs_need_grad``)."""
        if not self.inputs_need_grad:
            raise MXNetError("get_input_grads requires bind("
                             "inputs_need_grad=True)")
        exe = self._exec_group.execs[0]
        return [exe.grad_dict[n] for n in self._data_names]

    def install_monitor(self, mon) -> None:
        for exe in self._exec_group.execs:
            mon.install_to_executor(exe)

    def update_metric(self, eval_metric, labels) -> None:
        self._exec_group.update_metric(eval_metric, labels)

    # -- checkpoint --------------------------------------------------------
    def save_checkpoint(self, prefix: str, epoch: int,
                        save_optimizer_states: bool = False) -> None:
        arg, aux = self.get_params()
        save_checkpoint(prefix, epoch, self._symbol, arg, aux)
        if save_optimizer_states and self._updater is not None:
            with open(f"{prefix}-{epoch:04d}.states", "wb") as f:
                f.write(self._updater.get_states())

    @staticmethod
    def load(prefix: str, epoch: int, load_optimizer_states: bool = False,
             **kwargs) -> "Module":
        """A Module of the checkpoint's symbol whose parameters (and, on
        request, optimizer states) are loaded when it is bound (and its
        optimizer made)."""
        sym, arg, aux = load_checkpoint(prefix, epoch, ctx=cpu())
        mod = Module(sym, **kwargs)
        mod._preloaded = (arg, aux)
        if load_optimizer_states:
            mod._preloaded_states = f"{prefix}-{epoch:04d}.states"
        return mod
