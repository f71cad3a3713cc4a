"""The functional optimizer of the sharded training step.

Counterpart of ``mxnet_tpu/parallel/optim.py``: an imperative
``optimizer.Optimizer`` (hyperparameters, per-parameter ``lr_mult`` and
``wd_mult``) lowered to ``init(params) -> state`` and ``update(params,
grads, state, t, base_lr, rescale) -> (params, state)`` over lists of
tensors.  The JAX package's update is pure; here the tensors are updated
in place and returned, so that a caller may hand over views (a rank's
ZeRO slice of each parameter) and see the update land in the whole.

- ``sgd`` runs in the hand-written multi-tensor kernels
  (``kernels/multi_sgd.py``): the momentum kernel with momentum, the
  plain one without, all tensors of one dtype in one call;
- ``nag``, ``signum``, ``adam``, ``adagrad`` and ``rmsprop`` (plain and
  centered) run the port's update ops (``ndarray/ops_optimizer.py``), as
  ``gluon.Trainer`` does, which follow the JAX formulas: the gradient
  rescaled, clipped, then plus ``wd * w`` (AdaGrad's decay decoupled).

``t`` is the update count, ``base_lr`` the learning rate and ``rescale``
the gradient scale (``1 / batch_size``); each is rounded to float32 as
the JAX step traces them, and Adam's bias correction
``sqrt(1 - beta2**t) / (1 - beta1**t)`` is taken in float32 as well.
Row-sparse gradients (the lazy update) come with ROADMAP Queue A 3b.
"""
from __future__ import annotations

from typing import Any, List, Sequence

import numpy as np
import torch

from ..base import MXNetError
from .. import optimizer as opt_mod

__all__ = ["FunctionalOptimizer", "make_functional_optimizer"]

_KINDS = ("sgd", "nag", "signum", "adam", "adagrad", "rmsprop")


def _f32(x) -> float:
    return float(np.float32(x))


class FunctionalOptimizer:
    """``init(params) -> state``; ``update(params, grads, state, t,
    base_lr, rescale) -> (params, state)``, in place (see the module
    docstring)."""

    def __init__(self, kind: str, hyper: dict,
                 lr_mults: Sequence[float], wds: Sequence[float]):
        if kind not in _KINDS:
            raise MXNetError(f"no functional lowering for optimizer "
                             f"{kind!r}")
        self.kind = kind
        self.hyper = hyper
        self.lr_mults = list(lr_mults)
        self.wds = list(wds)

    # -- state -------------------------------------------------------------
    def init(self, params: List[torch.Tensor]) -> List[Any]:
        k = self.kind
        zeros = torch.zeros_like
        if k == "sgd":
            if self.hyper.get("momentum", 0.0):
                return [zeros(p) for p in params]
            return [() for _ in params]
        if k == "adam":
            return [(zeros(p), zeros(p)) for p in params]
        if k == "rmsprop" and self.hyper.get("centered", False):
            return [(zeros(p), zeros(p), zeros(p)) for p in params]
        # nag and signum keep momentum even at mu=0; adagrad, rmsprop
        return [zeros(p) for p in params]

    # -- update ------------------------------------------------------------
    @torch.no_grad()
    def update(self, params, grads, state, t, base_lr, rescale,
               sparse=frozenset()):
        """One step over the lists, in place; returns ``(params,
        state)``."""
        from ..ndarray import ops_optimizer as ops
        if sparse:
            raise MXNetError("row-sparse gradients (the lazy update) are "
                             "not ported yet: ROADMAP Queue A 3b")
        h = self.hyper
        clip = h.get("clip_gradient") or -1.0
        rescale = _f32(rescale)
        base_lr = np.float32(base_lr)
        lrs = [_f32(base_lr * np.float32(m)) for m in self.lr_mults]
        k = self.kind
        if k == "sgd":
            self._sgd(params, grads, state, lrs, rescale, clip)
            return params, state
        kw = {"rescale_grad": rescale, "clip_gradient": clip}
        if k == "adam":
            b1, b2 = h["beta1"], h["beta2"]
            tt = np.float32(t)
            one = np.float32(1.0)
            coef = np.sqrt(one - np.float32(b2) ** tt) / \
                (one - np.float32(b1) ** tt)
        for i, (w, g, s) in enumerate(zip(params, grads, state)):
            lr, wd = lrs[i], self.wds[i]
            if k == "nag":
                ops.nag_mom_update(w, g, s, lr, momentum=h.get(
                    "momentum", 0.0), wd=wd, **kw)
            elif k == "signum":
                ops.signum_update(w, g, s, lr, momentum=h.get(
                    "momentum", 0.0), wd=wd, wd_lh=h.get("wd_lh", 0.0),
                    **kw)
            elif k == "adam":
                ops.adam_update(w, g, s[0], s[1],
                                _f32(np.float32(lr) * coef),
                                beta1=b1, beta2=b2, epsilon=h["epsilon"],
                                wd=wd, **kw)
            elif k == "adagrad":
                ops.adagrad_update(w, g, s, lr, epsilon=h.get("eps", 1e-7),
                                   wd=wd, **kw)
            elif h.get("centered", False):
                ops.rmspropalex_update(
                    w, g, *s, lr, gamma1=h.get("gamma1", 0.95),
                    gamma2=h.get("gamma2", 0.9),
                    epsilon=h.get("epsilon", 1e-8), wd=wd,
                    clip_weights=h.get("clip_weights") or -1.0, **kw)
            else:
                ops.rmsprop_update(
                    w, g, s, lr, gamma1=h.get("gamma1", 0.95),
                    epsilon=h.get("epsilon", 1e-8), wd=wd,
                    clip_weights=h.get("clip_weights") or -1.0, **kw)
        return params, state

    def _sgd(self, params, grads, state, lrs, rescale, clip) -> None:
        """SGD in the multi-tensor kernels: one call per dtype over every
        tensor of it (plain versions on CPU tensors)."""
        from ..kernels.multi_sgd import multi_sgd, multi_sgd_mom
        mu = self.hyper.get("momentum", 0.0)
        by_dtype = {}
        for i, w in enumerate(params):
            by_dtype.setdefault(w.dtype, []).append(i)
        for idx in by_dtype.values():
            ws = [params[i] for i in idx]
            gs = [grads[i].contiguous() for i in idx]
            lr = [lrs[i] for i in idx]
            wd = [self.wds[i] for i in idx]
            if mu:
                multi_sgd_mom(ws, gs, [state[i] for i in idx], lr, wd,
                              momentum=mu, rescale_grad=rescale,
                              clip_gradient=clip)
            else:
                multi_sgd(ws, gs, lr, wd, rescale_grad=rescale,
                          clip_gradient=clip)


def make_functional_optimizer(opt: "opt_mod.Optimizer",
                              param_names: Sequence[str]
                              ) -> FunctionalOptimizer:
    """Lower an imperative Optimizer to the functional form, taking each
    parameter's ``lr_mult``/``wd_mult`` by index or name."""
    kind = type(opt).__name__.lower()
    hyper = dict(
        momentum=getattr(opt, "momentum", 0.0),
        beta1=getattr(opt, "beta1", 0.9),
        beta2=getattr(opt, "beta2", 0.999),
        epsilon=getattr(opt, "epsilon", 1e-8),
        eps=getattr(opt, "float_stable_eps", 1e-7),
        gamma1=getattr(opt, "gamma1", 0.95),
        gamma2=getattr(opt, "gamma2", 0.9),
        centered=getattr(opt, "centered", False),
        clip_weights=getattr(opt, "clip_weights", None),
        wd_lh=getattr(opt, "wd_lh", 0.0),
        clip_gradient=getattr(opt, "clip_gradient", None),
    )

    def _mult(table, i, name):
        p = opt.param_dict.get(i)
        attr = "lr_mult" if table is opt.lr_mult else "wd_mult"
        if p is not None:
            return getattr(p, attr, 1.0)
        if i in table:
            return table[i]
        return table.get(name, 1.0)

    lr_mults, wds = [], []
    for i, name in enumerate(param_names):
        lr_mults.append(float(_mult(opt.lr_mult, i, name)))
        wds.append(float(opt.wd) * float(_mult(opt.wd_mult, i, name)))
    return FunctionalOptimizer(kind, hyper, lr_mults, wds)
