"""Optimizers: the ``Optimizer`` base, the registry, ``SGD`` and ``Adam``.

Counterpart of ``mxnet_tpu/optimizer.py`` (the other optimizers come
later).
The base keeps MXNet's bookkeeping: ``rescale_grad`` (the Trainer sets it
to ``1 / batch_size`` each step), the learning rate and weight decay with
per-parameter ``lr_mult``/``wd_mult`` read from ``param_dict`` (the
Trainer's parameters), ``clip_gradient``, per-index update counts and
``multi_precision`` (an fp32 master copy of each fp16/bf16 weight).

``SGD.update_multi`` is the multi-tensor path of ``gluon.Trainer``: one
``multi_sgd_update`` / ``multi_sgd_mom_update`` /
``multi_mp_sgd_mom_update`` call per group, which on the card is one launch
of a hand-written kernel (fp32, bf16 or fp16 weights; the mixed path for
fp32 masters of bf16/fp16 weights).  It falls back to the per-tensor
update for the same cases as the reference (mixed weight dtypes;
multi-precision without momentum, which then runs ``mp_sgd_update``, or
with a state that is not a master pair).  ``create_state`` keeps the
momentum in the weight's dtype; with ``multi_precision`` the master and
its momentum are fp32.  Updates run under ``torch.no_grad()`` and change
the weights in place.

``Adam`` is MXNet's: the bias correction folds into the rate, ``lr_t = lr
* sqrt(1 - beta2^t) / (1 - beta1^t)`` with ``t`` the parameter's own
update count, and ``epsilon`` is added outside ``sqrt(var)``
(``adam_update``).  This is not ``torch.optim.Adam``'s formula, and the
port does not call ``torch.optim``.  With ``multi_precision`` an fp16/bf16
weight is updated through its fp32 master copy (the base class's
``update_multi_precision``).
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from .base import MXNetError, get_env
from .ndarray import ops_optimizer as ops

__all__ = ["Optimizer", "SGD", "Adam", "Updater", "get_updater",
           "register", "create"]

_registry: Dict[str, type] = {}


def _is_low_precision(dtype: torch.dtype) -> bool:
    return dtype in (torch.float16, torch.bfloat16)


def register(klass):
    _registry[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs) -> "Optimizer":
    """An optimizer by registered name (``"sgd"``), or an instance as
    is."""
    if isinstance(name, Optimizer):
        return name
    if name.lower() not in _registry:
        raise MXNetError(f"unknown optimizer {name!r}")
    return _registry[name.lower()](**kwargs)


def _is_mp_state(state) -> bool:
    return isinstance(state, tuple) and len(state) == 2 and \
        isinstance(state[1], torch.Tensor)


class Optimizer:
    """Base optimizer with per-index lr/wd multipliers and update
    counting."""

    def __init__(self, rescale_grad=1.0, wd=0.0, clip_gradient=None,
                 learning_rate=0.01, multi_precision=False, param_dict=None,
                 param_idx2name=None, **kwargs):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        self.param_dict = param_dict or {}
        self.idx2name = dict(param_idx2name or {})
        self.num_update = 0
        self._index_update_count: Dict[int, int] = {}
        # >1 enables the multi-tensor path in Trainer; only optimizers
        # with update_multi (SGD) set it
        self.aggregate_num = 0

    def _update_count(self, index) -> None:
        cnt = self._index_update_count.get(index, 0) + 1
        self._index_update_count[index] = cnt
        self.num_update = max(self.num_update, cnt)

    def set_learning_rate(self, lr: float) -> None:
        self.lr = lr

    @property
    def learning_rate(self) -> float:
        return self.lr

    def _mult(self, index, attr: str) -> float:
        param = self.param_dict.get(index)
        return 1.0 if param is None else getattr(param, attr)

    def _get_lr(self, index) -> float:
        return self.lr * self._mult(index, "lr_mult")

    def _get_wd(self, index) -> float:
        return self.wd * self._mult(index, "wd_mult")

    def create_state(self, index, weight):
        return None

    def create_state_multi_precision(self, index, weight):
        """With ``multi_precision`` and an fp16/bf16 weight: ``(state of
        the fp32 master, fp32 master)``; else the plain state."""
        if self.multi_precision and _is_low_precision(weight.dtype):
            w32 = weight.detach().float()
            return (self.create_state(index, w32), w32)
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def update_multi_precision(self, index, weight, grad, state):
        """The update; with a ``(state, fp32 master)`` pair from
        :meth:`create_state_multi_precision`, the update of the master
        from the fp32 gradient, then the master cast into the weight (SGD
        overrides this with its fused multi-precision op)."""
        if self.multi_precision and _is_mp_state(state):
            inner, w32 = state
            self.update(index, w32, grad.float(), inner)
            weight.copy_(w32)
        else:
            self.update(index, weight, grad, state)

    def _common_kwargs(self, index) -> Dict[str, Any]:
        kw = {"wd": self._get_wd(index), "rescale_grad": self.rescale_grad}
        if self.clip_gradient is not None:
            kw["clip_gradient"] = self.clip_gradient
        return kw


@register
class SGD(Optimizer):
    """SGD with momentum and multi-precision master weights."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.aggregate_num = int(get_env("MXNET_OPTIMIZER_AGGREGATION_SIZE"))

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return torch.zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = self._common_kwargs(index)
        lr = self._get_lr(index)
        if self.momentum == 0.0:
            ops.sgd_update(weight, grad, lr, **kw)
        else:
            ops.sgd_mom_update(weight, grad, state, lr,
                               momentum=self.momentum, **kw)

    def update_multi_precision(self, index, weight, grad, state):
        if self.multi_precision and _is_mp_state(state):
            mom, w32 = state
            self._update_count(index)
            if mom is None:
                ops.mp_sgd_update(weight, grad, w32, self._get_lr(index),
                                  **self._common_kwargs(index))
            else:
                ops.mp_sgd_mom_update(weight, grad, mom, w32,
                                      self._get_lr(index),
                                      momentum=self.momentum,
                                      **self._common_kwargs(index))
        else:
            self.update(index, weight, grad, state)

    def update_multi(self, indices, weights, grads, states):
        """One multi-tensor update over the group (the reference's
        multi_sgd_update family); per tensor for mixed dtypes, or
        multi-precision without momentum or without master pairs."""
        dt = weights[0].dtype
        mp = self.multi_precision and _is_mp_state(states[0])
        fallback = (any(w.dtype != dt for w in weights)
                    or (mp and self.momentum == 0.0)
                    or (mp and not all(isinstance(s, tuple)
                                       for s in states)))
        if fallback:
            for i, w, g, s in zip(indices, weights, grads, states):
                self.update_multi_precision(i, w, g, s)
            return
        for i in indices:
            self._update_count(i)
        lrs = [self._get_lr(i) for i in indices]
        wds = [self._get_wd(i) for i in indices]
        kw: Dict[str, Any] = {"rescale_grad": self.rescale_grad,
                              "num_weights": len(indices)}
        if self.clip_gradient is not None:
            kw["clip_gradient"] = self.clip_gradient
        data: list = []
        if mp:
            for w, g, (mom, w32) in zip(weights, grads, states):
                data.extend((w, g, mom, w32))
            ops.multi_mp_sgd_mom_update(*data, lrs, wds,
                                        momentum=self.momentum, **kw)
        elif self.momentum != 0.0:
            for w, g, s in zip(weights, grads, states):
                data.extend((w, g, s))
            ops.multi_sgd_mom_update(*data, lrs, wds,
                                     momentum=self.momentum, **kw)
        else:
            for w, g in zip(weights, grads):
                data.extend((w, g))
            ops.multi_sgd_update(*data, lrs, wds, **kw)


@register
class Adam(Optimizer):
    """Adam with MXNet's bias-corrected rate (see the module docstring)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        """``(mean, var)``, zeros like the weight."""
        return (torch.zeros_like(weight), torch.zeros_like(weight))

    def update(self, index, weight, grad, state):
        if grad.layout != torch.strided:
            raise MXNetError("Adam: sparse (row_sparse) gradients are not "
                             "ported; the lazy update comes with the "
                             "sparse slice")
        self._update_count(index)
        t = self._index_update_count[index]
        lr_t = self._get_lr(index) * math.sqrt(1.0 - self.beta2 ** t) \
            / (1.0 - self.beta1 ** t)
        mean, var = state
        ops.adam_update(weight, grad, mean, var, lr_t, beta1=self.beta1,
                        beta2=self.beta2, epsilon=self.epsilon,
                        **self._common_kwargs(index))


def _unwrap(x) -> torch.Tensor:
    return x._data if hasattr(x, "_data") else x


class Updater:
    """The optimizer as ``updater(index, grad, weight)`` on ``NDArray``s
    or tensors (MXNet's ``get_updater``, what ``Module.update`` and a
    kvstore call): the state of each index made at its first update, the
    weight updated in place under ``torch.no_grad()``.
    ``get_states``/``set_states`` pickle the states as numpy arrays, with
    the update counts when ``dump_optimizer``, in the JAX package's
    layout."""

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states: Dict[Any, Any] = {}

    @torch.no_grad()
    def __call__(self, index, grad, weight) -> None:
        w, g = _unwrap(weight), _unwrap(grad)
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, w)
        self.optimizer.update_multi_precision(index, w, g,
                                              self.states[index])

    def get_states(self, dump_optimizer: bool = False) -> bytes:
        import pickle
        blob = {"states": {k: _states_to_np(v)
                           for k, v in self.states.items()}}
        if dump_optimizer:
            blob["num_update"] = self.optimizer.num_update
            blob["index_update_count"] = \
                dict(self.optimizer._index_update_count)
        return pickle.dumps(blob)

    def set_states(self, states: bytes, device=None) -> None:
        """Load ``get_states``' bytes, the states onto ``device`` (the
        device of the first state already held, else the CPU)."""
        import pickle
        loaded = pickle.loads(states)
        if "states" not in loaded:
            loaded = {"states": loaded}
        if device is None:
            held = [t for v in self.states.values()
                    for t in _flat(v)]
            device = held[0].device if held else torch.device("cpu")
        self.states = {k: _states_from_np(v, device)
                       for k, v in loaded["states"].items()}
        if "num_update" in loaded:
            self.optimizer.num_update = loaded["num_update"]
            self.optimizer._index_update_count = dict(
                loaded["index_update_count"])


def _flat(state):
    if state is None:
        return []
    if isinstance(state, tuple):
        return [t for s in state for t in _flat(s)]
    return [state]


def _states_to_np(state):
    if state is None:
        return None
    if isinstance(state, tuple):
        return tuple(_states_to_np(s) for s in state)
    return _unwrap(state).detach().cpu().numpy()


def _states_from_np(state, device):
    if state is None:
        return None
    if isinstance(state, tuple):
        return tuple(_states_from_np(s, device) for s in state)
    return torch.as_tensor(state).to(device)


def get_updater(optimizer: Optimizer) -> Updater:
    return Updater(optimizer)
