"""Optimizers: the ``Optimizer`` base, the registry, the JAX package's 17
optimizers and ``Updater``.

Counterpart of ``mxnet_tpu/optimizer.py``.  The base keeps MXNet's
bookkeeping (:50-175): ``rescale_grad`` (the Trainer sets it to ``1 /
batch_size`` each step), the learning rate, from ``lr_scheduler`` when
one is set (its ``base_lr`` set from ``learning_rate``;
``set_learning_rate`` then raises) at the optimizer's ``num_update``,
weight decay, per-parameter ``lr_mult``/``wd_mult`` looked up in
``param_dict`` (the Trainer's parameters) first, then by index in the
``set_lr_mult``/``set_wd_mult`` dicts, then by the name
``param_idx2name`` gives the index; ``clip_gradient``, per-index update
counts that start from ``begin_num_update``, ``multi_precision`` (an
fp32 master copy of each fp16/bf16 weight: ``(state of the master,
master)``, the update run on the master from the fp32-cast gradient and
the master rounded into the weight) and ``extra_state`` (scalar state
beyond the per-parameter tensors, which ``Updater.get_states`` and
``Trainer.save_states`` write: Nadam's momentum schedule).

The optimizers compose the update operators of ``ndarray/ops_optimizer``
on tensors, in place, under ``torch.no_grad()``; the rates are host
numbers, so an update reads nothing back from the card.  Each follows
its JAX class line for line:

- ``SGD`` (momentum, the fused multi-precision op, and ``update_multi``:
  the multi-tensor path of ``gluon.Trainer``, one
  ``multi_sgd_update`` / ``multi_sgd_mom_update`` /
  ``multi_mp_sgd_mom_update`` call per group, one launch of a
  hand-written kernel on the card; every index of a group is counted
  before any rate is read, so with a schedule the group's first step
  takes the rate at the new count), ``NAG``, ``AdaGrad``, ``RMSProp``
  (plain and ``centered``), ``Ftrl``, ``Signum``, ``FTML`` and
  ``AdamW`` (decoupled weight decay, fp32 states, ``mp_adamw_update``
  for fp16/bf16 weights) through their fused ops;
- ``Adam``: MXNet's bias correction folded into the rate, ``lr_t = lr *
  sqrt(1 - beta2^t) / (1 - beta1^t)`` with ``t`` the parameter's own
  update count, ``epsilon`` outside ``sqrt(var)`` (not
  ``torch.optim.Adam``'s formula; the port does not call
  ``torch.optim``);
- ``LARS``, ``LBSGD`` (warmup ``linear``, ``power2``, ``sqrt``, or the
  trust ratio every step with ``lars``) and ``LAMB`` (two phases, fp32
  moments, ``mp_lamb_*`` with fp32 masters): the layer-wise ratio is
  computed on the device (``lars_trust``; LAMB's norms ``r1``/``r2``)
  and enters the update as a device tensor, so their steps read
  nothing back either;
- ``AdaDelta``, ``Adamax``, ``Nadam``, ``SGLD`` and ``DCASGD``: host-side
  compositions of torch ops, as the reference composes ``nd`` ops (the
  Python optimizers add ``wd * weight`` before clipping; SGLD and DCASGD
  add it after).  SGLD's noise is drawn from ``mx.random``'s generator of
  the weight's device.
"""
from __future__ import annotations

import math
import pickle
from typing import Any, Dict

import numpy as np
import torch

from . import random as _random
from .base import MXNetError, get_env
from .ndarray import ops_optimizer as ops

__all__ = ["Optimizer", "SGD", "NAG", "Adam", "AdaGrad", "RMSProp", "Ftrl",
           "Signum", "AdaDelta", "AdamW", "LARS", "LBSGD", "Adamax",
           "Nadam", "SGLD", "DCASGD", "FTML", "LAMB", "Updater",
           "get_updater", "register", "create"]

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


def _is_mp_state(state, weight) -> bool:
    """A ``(state, fp32 master)`` pair of a low-precision weight."""
    return (isinstance(state, tuple) and len(state) == 2
            and isinstance(state[1], torch.Tensor)
            and state[1].dtype == torch.float32
            and weight.dtype != torch.float32)


def _zeros(weight, dtype=None):
    return torch.zeros_like(weight, dtype=dtype)


class Optimizer:
    """Base optimizer (see the module docstring)."""

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 multi_precision=False, param_dict=None, begin_num_update=0,
                 **kwargs):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        self.param_idx2name = dict(param_idx2name or {})
        self.idx2name = self.param_idx2name
        self.param_dict = param_dict or {}
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count: Dict[Any, int] = {}
        self.lr_mult: Dict[Any, float] = {}
        self.wd_mult: Dict[Any, float] = {}
        # >1 enables the multi-tensor path in Trainer; only optimizers
        # with update_multi (SGD) set it
        self.aggregate_num = 0

    def extra_state(self):
        """Scalar state beyond the per-parameter tensors (None: none)."""
        return None

    def set_extra_state(self, extra) -> None:
        pass

    def _update_count(self, index) -> None:
        cnt = self._index_update_count.get(index, self.begin_num_update) + 1
        self._index_update_count[index] = cnt
        self.num_update = max(self.num_update, cnt)

    def set_learning_rate(self, lr: float) -> None:
        if self.lr_scheduler is not None:
            raise MXNetError("cannot set lr directly when lr_scheduler "
                             "is set")
        self.lr = lr

    @property
    def learning_rate(self) -> float:
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def _mult(self, index, attr: str, table: Dict) -> float:
        param = self.param_dict.get(index)
        if param is not None:
            return getattr(param, attr)
        if index in table:
            return table[index]
        if index in self.param_idx2name:
            return table.get(self.param_idx2name[index], 1.0)
        return 1.0

    def _get_lr(self, index) -> float:
        return self.learning_rate * self._mult(index, "lr_mult",
                                               self.lr_mult)

    def _get_wd(self, index) -> float:
        return self.wd * self._mult(index, "wd_mult", self.wd_mult)

    def set_lr_mult(self, args_lr_mult: Dict) -> None:
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult: Dict) -> None:
        self.wd_mult = dict(args_wd_mult)

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
        from the fp32 gradient, then the master rounded into the
        weight."""
        if self.multi_precision and _is_mp_state(state, weight):
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

    def _prepped(self, index, grad, weight, with_wd: bool = True):
        """The Python optimizers' gradient: rescaled, plus ``wd * weight``
        (``with_wd``), then clipped (the fused ops clip first)."""
        g = grad * self.rescale_grad
        if with_wd:
            wd = self._get_wd(index)
            if wd:
                g = g + wd * weight
        if self.clip_gradient is not None:
            g = g.clamp(-self.clip_gradient, self.clip_gradient)
        return g


@register
class SGD(Optimizer):
    """SGD with momentum and multi-precision master weights."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update
        self.aggregate_num = int(get_env("MXNET_OPTIMIZER_AGGREGATION_SIZE"))

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _zeros(weight)

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
        if self.multi_precision and _is_mp_state(state, weight):
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
        mp = self.multi_precision and _is_mp_state(states[0], weights[0])
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
class NAG(Optimizer):
    """Nesterov accelerated SGD (``nag_mom_update``)."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _zeros(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        if state is None:
            ops.sgd_update(weight, grad, lr, **self._common_kwargs(index))
        else:
            ops.nag_mom_update(weight, grad, state, lr,
                               momentum=self.momentum,
                               **self._common_kwargs(index))


@register
class Adam(Optimizer):
    """Adam with MXNet's bias-corrected rate (see the module docstring)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        """``(mean, var)``, zeros like the weight."""
        return (_zeros(weight), _zeros(weight))

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


@register
class AdaGrad(Optimizer):
    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        ops.adagrad_update(weight, grad, state, self._get_lr(index),
                           epsilon=self.float_stable_eps,
                           **self._common_kwargs(index))


@register
class RMSProp(Optimizer):
    """RMSProp, or with ``centered`` Graves's (``rmspropalex_update``,
    state ``(n, g_avg, delta)``)."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2
        self.epsilon = epsilon
        self.centered = centered
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return (_zeros(weight), _zeros(weight), _zeros(weight))
        return _zeros(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = self._common_kwargs(index)
        kw.update(gamma1=self.gamma1, epsilon=self.epsilon)
        if self.clip_weights is not None:
            kw["clip_weights"] = self.clip_weights
        lr = self._get_lr(index)
        if self.centered:
            ops.rmspropalex_update(weight, grad, *state, lr,
                                   gamma2=self.gamma2, **kw)
        else:
            ops.rmsprop_update(weight, grad, state, lr, **kw)


@register
class Ftrl(Optimizer):
    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1 = lamda1
        self.beta = beta

    def create_state(self, index, weight):
        """``(z, n)``."""
        return (_zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        z, n = state
        ops.ftrl_update(weight, grad, z, n, self._get_lr(index),
                        lamda1=self.lamda1, beta=self.beta,
                        **self._common_kwargs(index))


@register
class Signum(Optimizer):
    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _zeros(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = self._common_kwargs(index)
        lr = self._get_lr(index)
        if state is None:
            ops.signsgd_update(weight, grad, lr, **kw)
        else:
            ops.signum_update(weight, grad, state, lr,
                              momentum=self.momentum, wd_lh=self.wd_lh,
                              **kw)


@register
class AdaDelta(Optimizer):
    """AdaDelta, composed of torch ops (no fused op in the reference)."""

    def __init__(self, rho=0.9, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        """``(acc_g, acc_delta)``."""
        return (_zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        acc_g, acc_d = state
        wd = self._get_wd(index)
        g = self._prepped(index, grad, weight, with_wd=False)
        acc_g.copy_(self.rho * acc_g + (1 - self.rho) * g * g)
        delta = torch.sqrt(acc_d + self.epsilon) / \
            torch.sqrt(acc_g + self.epsilon) * g
        acc_d.copy_(self.rho * acc_d + (1 - self.rho) * delta * delta)
        weight.copy_(weight - delta - wd * weight)


@register
class AdamW(Optimizer):
    """Adam with decoupled weight decay (``adamw_update``): the
    bias-corrected rate goes to the op's ``lr``, and ``wd * lr`` (the
    plain rate) to its ``wd``, so the decay is ``w -= lr * wd * w``.
    fp32 moments; with ``multi_precision`` fp32 masters for fp16/bf16
    weights (``mp_adamw_update``)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, eta=1.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon, self.eta = \
            beta1, beta2, epsilon, eta

    def create_state(self, index, weight):
        return (_zeros(weight, torch.float32), _zeros(weight, torch.float32))

    def _corrected_lr(self, index):
        t = self._index_update_count[index]
        return self._get_lr(index) * \
            math.sqrt(1.0 - self.beta2 ** t) / (1.0 - self.beta1 ** t)

    def _kw(self, index):
        kw = {"beta1": self.beta1, "beta2": self.beta2,
              "epsilon": self.epsilon,
              "wd": self._get_wd(index) * self._get_lr(index),
              "eta": self.eta, "rescale_grad": self.rescale_grad}
        if self.clip_gradient is not None:
            kw["clip_gradient"] = self.clip_gradient
        return kw

    def update(self, index, weight, grad, state):
        self._update_count(index)
        mean, var = state
        ops.adamw_update(weight, grad, mean, var, self._corrected_lr(index),
                         **self._kw(index))

    def update_multi_precision(self, index, weight, grad, state):
        # the mp state is ((mean, var), w32), the plain one (mean, var)
        if self.multi_precision and isinstance(state, tuple) and \
                len(state) == 2 and isinstance(state[0], tuple) and \
                isinstance(state[1], torch.Tensor):
            (mean, var), w32 = state
            self._update_count(index)
            ops.mp_adamw_update(weight, grad, mean, var, w32,
                                self._corrected_lr(index), **self._kw(index))
        else:
            self.update(index, weight, grad, state)


def _lars_trust(opt, index, weight, grad):
    """The layer's trust ratio, a 0-d fp32 tensor on the weight's
    device."""
    return ops.lars_trust(weight, grad, opt._get_wd(index), eta=opt.eta,
                          epsilon=opt.epsilon, rescale_grad=opt.rescale_grad)


def _sgd_step(opt, index, weight, grad, state, lr):
    kw = opt._common_kwargs(index)
    if opt.momentum == 0.0:
        ops.sgd_update(weight, grad, lr, **kw)
    else:
        ops.sgd_mom_update(weight, grad, state, lr, momentum=opt.momentum,
                           **kw)


@register
class LARS(Optimizer):
    """Layer-wise Adaptive Rate Scaling (You et al. 2017): the rate times
    the layer's trust ratio ``eta * |w| / (|g| + wd * |w| + epsilon)``,
    computed on the device, into the SGD update."""

    def __init__(self, momentum=0.9, eta=0.001, epsilon=1e-8, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.eta = eta
        self.epsilon = epsilon

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _zeros(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index) * _lars_trust(self, index, weight, grad)
        _sgd_step(self, index, weight, grad, state, lr)


@register
class LBSGD(Optimizer):
    """Large-batch SGD: the rate ramped over ``warmup_epochs *
    updates_per_epoch`` updates (``linear``, ``power2``, ``sqrt``), or
    scaled by the LARS trust ratio every step (``lars``)."""

    def __init__(self, momentum=0.0, multi_precision=False,
                 warmup_strategy="linear", warmup_epochs=5,
                 batch_scale=1, updates_per_epoch=32, begin_epoch=0,
                 num_epochs=60, eta=0.001, **kwargs):
        super().__init__(multi_precision=multi_precision, **kwargs)
        self.momentum = momentum
        self.warmup_strategy = warmup_strategy
        self.warmup_epochs = warmup_epochs
        self.batch_scale = batch_scale
        self.updates_per_epoch = max(1, updates_per_epoch)
        self.begin_epoch = begin_epoch
        self.num_epochs = num_epochs
        self.eta = eta
        self.epsilon = 1e-8

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _zeros(weight)

    def _warmup_scale(self, index) -> float:
        t = self._index_update_count[index]
        warm_t = self.warmup_epochs * self.updates_per_epoch
        if self.warmup_strategy not in ("linear", "power2", "sqrt") or \
                t >= warm_t:
            return 1.0
        frac = t / warm_t
        if self.warmup_strategy == "linear":
            return frac
        if self.warmup_strategy == "power2":
            return frac * frac
        return math.sqrt(frac)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index) * self._warmup_scale(index)
        if self.warmup_strategy == "lars":
            lr = lr * _lars_trust(self, index, weight, grad)
        _sgd_step(self, index, weight, grad, state, lr)


@register
class FTML(Optimizer):
    """Follow The Moving Leader (``ftml_update``), state ``(d, v, z)``."""

    def __init__(self, learning_rate=0.0025, beta1=0.6, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = {"beta1": self.beta1, "beta2": self.beta2,
              "epsilon": self.epsilon, "t": self._index_update_count[index],
              "wd": self._get_wd(index), "rescale_grad": self.rescale_grad}
        if self.clip_gradient is not None:
            kw["clip_grad"] = self.clip_gradient
        ops.ftml_update(weight, grad, *state, self._get_lr(index), **kw)


@register
class LAMB(Optimizer):
    """Layer-wise Adaptive Moments for Batch training: phase 1 the
    Adam-style direction (fp32 moments), phase 2 the step scaled by the
    trust ratio ``|w| / |direction|``, both norms on the device; with
    ``multi_precision`` fp32 masters for fp16/bf16 weights."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 bias_correction=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lower_bound = lower_bound
        self.upper_bound = upper_bound
        self.bias_correction = bias_correction

    def create_state(self, index, weight):
        return (_zeros(weight, torch.float32), _zeros(weight, torch.float32))

    def _phase1_kwargs(self, index):
        kw = {"beta1": self.beta1, "beta2": self.beta2,
              "epsilon": self.epsilon,
              "t": self._index_update_count[index],
              "bias_correction": self.bias_correction,
              "wd": self._get_wd(index), "rescale_grad": self.rescale_grad}
        if self.clip_gradient is not None:
            kw["clip_gradient"] = self.clip_gradient
        return kw

    def _phase2_kwargs(self):
        return {"lower_bound": self.lower_bound,
                "upper_bound": self.upper_bound}

    def update(self, index, weight, grad, state):
        self._update_count(index)
        mean, var = state
        direction, _, _ = ops.lamb_update_phase1(
            weight, grad, mean, var, **self._phase1_kwargs(index))
        ops.lamb_update_phase2(weight, direction, ops._norm32(weight),
                               ops._norm32(direction), self._get_lr(index),
                               **self._phase2_kwargs())

    def update_multi_precision(self, index, weight, grad, state):
        if not (self.multi_precision and _is_low_precision(weight.dtype)):
            return self.update(index, weight, grad, state)
        self._update_count(index)
        (mean, var), w32 = state
        direction, _, _ = ops.mp_lamb_update_phase1(
            weight, grad, mean, var, w32, **self._phase1_kwargs(index))
        ops.mp_lamb_update_phase2(weight, direction, ops._norm32(w32),
                                  ops._norm32(direction), w32,
                                  self._get_lr(index),
                                  **self._phase2_kwargs())


@register
class Adamax(Optimizer):
    """AdaMax: Adam with the infinity norm."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2 = beta1, beta2

    def create_state(self, index, weight):
        """``(m, u)``."""
        return (_zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        lr = self._get_lr(index) / (1.0 - self.beta1 ** t)
        g = self._prepped(index, grad, weight)
        m, u = state
        m.copy_(self.beta1 * m + (1.0 - self.beta1) * g)
        u.copy_(torch.maximum(self.beta2 * u, torch.abs(g)))
        weight.copy_(weight - lr * m / (u + 1e-8))


@register
class Nadam(Optimizer):
    """Nesterov Adam (Dozat 2016): Adam with the momentum schedule
    ``m_schedule``, the product of the ``mu_t`` so far, kept as
    ``extra_state`` so that a resumed run continues it."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2 = beta1, beta2
        self.epsilon = epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0

    def extra_state(self):
        return {"m_schedule": self.m_schedule}

    def set_extra_state(self, extra) -> None:
        self.m_schedule = float(extra["m_schedule"])

    def create_state(self, index, weight):
        """``(m, v)``."""
        return (_zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        lr = self._get_lr(index)
        g = self._prepped(index, grad, weight)
        mu_t = self.beta1 * (1.0 - 0.5 * 0.96 ** (t * self.schedule_decay))
        mu_t1 = self.beta1 * (1.0 - 0.5 * 0.96 **
                              ((t + 1) * self.schedule_decay))
        self.m_schedule = self.m_schedule * mu_t
        m_schedule_next = self.m_schedule * mu_t1
        m, v = state
        m.copy_(self.beta1 * m + (1.0 - self.beta1) * g)
        v.copy_(self.beta2 * v + (1.0 - self.beta2) * g * g)
        g_prime = g / (1.0 - self.m_schedule)
        m_prime = m / (1.0 - m_schedule_next)
        v_prime = v / (1.0 - self.beta2 ** t)
        m_bar = (1.0 - mu_t) * g_prime + mu_t1 * m_prime
        weight.copy_(weight - lr * m_bar / (torch.sqrt(v_prime)
                                            + self.epsilon))


@register
class SGLD(Optimizer):
    """Stochastic Gradient Langevin Dynamics: a half gradient step plus
    N(0, lr) noise, drawn from ``mx.random``'s generator of the weight's
    device."""

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        g = self._prepped(index, grad, weight, with_wd=False)
        g = g + self._get_wd(index) * weight
        noise = torch.empty_like(weight).normal_(
            0.0, math.sqrt(lr), generator=_random.generator(weight.device))
        weight.copy_(weight - 0.5 * lr * g + noise)


@register
class DCASGD(Optimizer):
    """Delay-compensated asynchronous SGD: the gradient plus ``lamda * g^2
    * (w - w_prev)``; state ``(momentum or None, previous weight)``."""

    def __init__(self, learning_rate=0.01, momentum=0.0, lamda=0.04,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.lamda = lamda

    def create_state(self, index, weight):
        mom = None if self.momentum == 0.0 else _zeros(weight)
        return (mom, weight.detach().clone())

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        g = self._prepped(index, grad, weight, with_wd=False)
        wd = self._get_wd(index)
        mom, prev = state
        comp = g + wd * weight + self.lamda * g * g * (weight - prev)
        if mom is None:
            step = -lr * comp
        else:
            mom.copy_(self.momentum * mom - lr * comp)
            step = mom
        prev.copy_(weight)
        weight.copy_(weight + step)


def _unwrap(x) -> torch.Tensor:
    return x._data if hasattr(x, "_data") else x


class Updater:
    """The optimizer as ``updater(index, grad, weight)`` on ``NDArray``s
    or tensors (MXNet's ``get_updater``, what ``Module.update`` and a
    kvstore call): the state of each index made at its first update, the
    weight updated in place under ``torch.no_grad()``.
    ``get_states``/``set_states`` pickle the states as numpy arrays, with
    the update counts and the optimizer's ``extra_state`` when
    ``dump_optimizer``, in the JAX package's layout."""

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
        blob = {"states": {k: states_to_np(v)
                           for k, v in self.states.items()}}
        if dump_optimizer:
            blob.update(optimizer_blob(self.optimizer))
        return pickle.dumps(blob)

    def set_states(self, states: bytes, device=None) -> None:
        """Load ``get_states``' bytes, the states onto ``device`` (the
        device of the first state already held, else the CPU)."""
        loaded = pickle.loads(states)
        if "states" not in loaded:
            loaded = {"states": loaded}
        if device is None:
            held = [t for v in self.states.values()
                    for t in _flat(v)]
            device = held[0].device if held else torch.device("cpu")
        self.states = {k: states_from_np(v, device)
                       for k, v in loaded["states"].items()}
        if "num_update" in loaded:
            self.optimizer.num_update = loaded["num_update"]
            self.optimizer._index_update_count = dict(
                loaded["index_update_count"])
        if "optimizer_extra" in loaded:
            self.optimizer.set_extra_state(loaded["optimizer_extra"])


def optimizer_blob(optimizer: Optimizer) -> Dict[str, Any]:
    """The optimizer's counts and ``extra_state`` as a checkpoint writes
    them (``optimizer_extra`` only where there is one)."""
    blob = {"num_update": optimizer.num_update,
            "index_update_count": dict(optimizer._index_update_count)}
    extra = optimizer.extra_state()
    if extra is not None:
        blob["optimizer_extra"] = extra
    return blob


def _flat(state):
    if state is None:
        return []
    if isinstance(state, tuple):
        return [t for s in state for t in _flat(s)]
    return [state]


def states_to_np(state):
    """A state (a tensor, None, or nested tuples of them) as numpy arrays
    (bfloat16 as float32, as ``nd.save`` writes it)."""
    if state is None:
        return None
    if isinstance(state, tuple):
        return tuple(states_to_np(s) for s in state)
    t = _unwrap(state).detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


def states_from_np(state, device, like=None):
    """:func:`states_to_np`'s arrays (or the JAX package's, bfloat16 by
    its bits) as tensors on ``device``, each in the dtype of its
    counterpart in ``like`` (a fresh state of the same structure) where
    there is one."""
    from .gluon.parameter import _from_numpy
    if state is None:
        return None
    if isinstance(state, tuple):
        likes = like if isinstance(like, tuple) and \
            len(like) == len(state) else (None,) * len(state)
        return tuple(states_from_np(s, device, lk)
                     for s, lk in zip(state, likes))
    t = _from_numpy(np.asarray(state)).to(device)
    if isinstance(like, torch.Tensor):
        t = t.to(like.dtype)
    return t


def get_updater(optimizer: Optimizer) -> Updater:
    return Updater(optimizer)
