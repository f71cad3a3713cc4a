"""Optimizer update operators, in place on their weight and state
tensors.

Counterpart of ``mxnet_tpu/ndarray/ops_optimizer.py``; the SGD family:

- per tensor: ``sgd_update(weight, grad, lr, ...)`` and
  ``sgd_mom_update(weight, grad, mom, lr, ...)`` (plain torch; the JAX
  package leaves them to XLA), and the multi-precision
  ``mp_sgd_update(weight, grad, weight32, lr, ...)`` and
  ``mp_sgd_mom_update(weight, grad, mom, weight32, lr, ...)``, which run
  the mixed path of ``kernels/multi_sgd.py`` on a group of one (the
  kernel on the card);
- multi-tensor, through the hand-written kernels of
  ``kernels/multi_sgd.py`` on the card, with the reference's interleaved
  inputs followed by the per-tensor lr and wd sequences:
  ``multi_sgd_update(w0, g0, w1, g1, ..., lrs, wds)``,
  ``multi_sgd_mom_update(w0, g0, m0, ..., lrs, wds)`` and
  ``multi_mp_sgd_mom_update(w0, g0, m0, w32_0, ..., lrs, wds)``.

``adam_update(weight, grad, mean, var, lr, ...)`` is plain torch, as the
JAX package leaves it to XLA (it has no Pallas kernel for Adam): the
gradient ``g = c + wd * weight`` (rescaled, clipped), then ``mean =
beta1 * mean + (1 - beta1) * g``, ``var = beta2 * var + (1 - beta2) *
g^2`` and ``weight -= lr * mean / (sqrt(var) + epsilon)``; the caller
folds the bias correction into ``lr``.  So are the other update
operators of the JAX package (:67-421), by its names: ``nag_mom_update``
and ``mp_nag_mom_update``, ``ftrl_update``, ``signsgd_update``,
``signum_update``, ``rmsprop_update``, ``rmspropalex_update``,
``adagrad_update``, ``_contrib_group_adagrad_update``,
``_contrib_adamw_update`` and ``_contrib_mp_adamw_update``,
``lars_trust`` and ``multi_lars``, ``ftml_update``, LAMB's
``lamb_update_phase1``/``_phase2`` and their ``mp_`` forms, and
``multi_sum_sq`` (``ops_misc.py:430``); these also stand in the op
registry, and so do the SGD family and ``adam_update`` (their registry
form is their ``NDArray`` form).  Their scalar inputs (a learning rate,
LARS's trust ratio, LAMB's ``r1``/``r2``) may be tensors on the card,
which stay there: an update composed of them (LARS, LBSGD, LAMB) reads
nothing back.

On tensors, every operator writes its outputs into its inputs (weights,
momenta, fp32 masters) and returns them in the reference's output order:
the form ``gluon.Trainer`` calls.  On ``NDArray``s they follow MXNet
(``optimizer_op.cc``): the states (``mom``, ``mean``/``var``, the fp32
masters) are updated in place, and the new weight is the result, written
into the weight only through ``out=`` (``out=weight`` updates in place,
with no copy; for the multi ops ``out`` lists the weights).  ``out`` may
also take the JAX package's form, every output in order (``[w, m]``,
``[w0, m0, w1, m1, ...]``).  The JAX package's ops mutate nothing and
return every output (``sgd_mom_update`` gives ``(weight, mom)``).  A
learning rate or an ``lrs``/``wds`` array may be an ``NDArray``: the
kernels take host floats, so one on the card costs one device-to-host
read per call (counted in ``engine.stats()["host_reads"]``).  The update is
``w - lr * (c + wd * w)`` with ``c = grad * rescale_grad`` clipped to
``[-clip_gradient, clip_gradient]`` when ``clip_gradient > 0``; the
momentum form keeps ``m = momentum * m - lr * (c + wd * w)`` and adds it
to ``w``.  On bf16/fp16 weights the SGD ops round as the JAX package does
(lr, wd and momentum to the weight's dtype, ``grad * rescale_grad`` in the
gradient's; ``kernels/multi_sgd.py``).  The multi-precision forms run the
fp32 update on the master weight ``w32`` (the gradient cast to fp32) and
store ``w32`` rounded into the low-precision weight, in the same pass.
Operators take no gradient: call them outside ``autograd.record()`` or
under ``torch.no_grad()``.
"""
from __future__ import annotations

import functools
from time import perf_counter
from typing import List

import numpy as np
import torch

from ..base import MXNetError
from ..engine import engine as _engine
from ..kernels.multi_sgd import (_clip, multi_mp_sgd, multi_mp_sgd_mom,
                                 multi_sgd, multi_sgd_mom,
                                 multi_sgd_mom_plain, multi_sgd_plain)
from .ndarray import NDArray
from .register import register_op


def _t(x):
    return x._data if isinstance(x, NDArray) else x


def _host(x) -> List[float]:
    """A number, a sequence or an array of numbers as host floats (one
    device-to-host read for an array on the card)."""
    x = _t(x)
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            _engine().host_reads += 1
        return [float(v) for v in x.detach().reshape(-1).tolist()]
    if isinstance(x, (list, tuple)):
        return [float(v) for v in x]
    return [float(x)]


def _one(x, op: str, what: str) -> float:
    """A rate given as one number, or an array of one element, as a host
    float; a many-element array raises (MXNet's ``lr`` and ``wd`` are
    scalar attributes)."""
    t = _t(x)
    n = t.numel() if isinstance(t, torch.Tensor) else \
        len(t) if isinstance(t, (list, tuple)) else 1
    if n != 1:
        raise MXNetError(f"{op}: {what} must be one number, got {n} "
                         f"elements")
    return _host(t)[0]


def _same(a, b: torch.Tensor) -> bool:
    a = _t(a)
    return (a.data_ptr() == b.data_ptr() and a.shape == b.shape
            and a.dtype == b.dtype and a.stride() == b.stride())


def _flat_tensors(res) -> List[torch.Tensor]:
    if isinstance(res, (list, tuple)):
        return [t for r in res for t in _flat_tensors(r)]
    res = _t(res)
    return [res] if isinstance(res, torch.Tensor) else []


def _reported(op):
    """``op`` reporting each call to the engine's listeners and waiting
    under NaiveEngine, as ``register.invoke`` does for every other op
    (so ``mx.profiler`` and ``Monitor`` see the updates, as in the JAX
    package, where they go through ``invoke``).  ``op.unreported`` is the
    call without the report: the registry's forms use it, as ``invoke``
    reports them itself."""
    name = op.__name__

    @functools.wraps(op)
    def call(*args, **kwargs):
        eng = _engine()
        if not eng.hooked:
            return op(*args, **kwargs)
        t0 = perf_counter()
        res = op(*args, **kwargs)
        eng.on_op(name, _flat_tensors(res), (perf_counter() - t0) * 1e6)
        return res
    call.unreported = op
    return call


def _on_ndarrays(n_states: int, n_host: int = 1):
    """The ``NDArray`` form of a per-tensor update ``fn(weight, grad,
    *states, *host_scalars, ...)`` that works in place on tensors: the
    new weight goes to a copy (or to ``weight`` itself under
    ``out=weight``), the states are updated in place."""
    def deco(fn):
        @functools.wraps(fn)
        def op(*args, out=None, **kwargs):
            if not any(isinstance(a, NDArray) for a in args):
                return fn(*args, **kwargs)
            k = 2 + n_states
            tensors = [_t(a) for a in args[:k]]
            scalars = [_one(a, fn.__name__, "lr")
                       for a in args[k:k + n_host]]
            if isinstance(kwargs.get("wd"), (NDArray, torch.Tensor)):
                kwargs["wd"] = _one(kwargs["wd"], fn.__name__, "wd")
            outs = None if out is None else \
                (list(out) if isinstance(out, (list, tuple)) else [out])
            w = tensors[0]
            if outs is None or not _same(outs[0], w):
                w = w.clone()
            with torch.no_grad():
                fn(w, *tensors[1:], *scalars, *args[k + n_host:], **kwargs)
            if outs is None:
                return NDArray(w)
            results = [w] + tensors[2:]
            with torch.no_grad():
                for tgt, src in zip(outs, results):
                    if not _same(tgt, src):
                        _t(tgt).copy_(src)
            return out
        return _reported(op)
    return deco

__all__ = ["sgd_update", "sgd_mom_update", "mp_sgd_update",
           "mp_sgd_mom_update", "multi_sgd_update", "multi_sgd_mom_update",
           "multi_mp_sgd_mom_update", "adam_update", "nag_mom_update",
           "mp_nag_mom_update", "ftrl_update", "signsgd_update",
           "signum_update", "rmsprop_update", "rmspropalex_update",
           "adagrad_update", "group_adagrad_update", "adamw_update",
           "mp_adamw_update", "lars_trust", "multi_lars", "ftml_update",
           "lamb_update_phase1", "lamb_update_phase2",
           "mp_lamb_update_phase1", "mp_lamb_update_phase2",
           "multi_sum_sq"]


@_on_ndarrays(0)
@torch.no_grad()
def sgd_update(weight, grad, lr, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0):
    """On tensors ``lr`` may be a tensor (LARS's scaled rate): it stays
    on the device."""
    if isinstance(lr, torch.Tensor):
        weight.sub_(_scalar(lr, weight) * _prep_grad(
            grad, wd, weight, rescale_grad, clip_gradient))
        return weight
    multi_sgd_plain([weight], [grad], [lr], [wd], rescale_grad,
                    clip_gradient)
    return weight


@_on_ndarrays(1)
@torch.no_grad()
def sgd_mom_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    """On tensors ``lr`` may be a tensor, as for :func:`sgd_update`."""
    if isinstance(lr, torch.Tensor):
        g = _prep_grad(grad, wd, weight, rescale_grad, clip_gradient)
        mom.mul_(momentum).sub_(_scalar(lr, weight) * g)
        weight.add_(mom)
        return weight, mom
    multi_sgd_mom_plain([weight], [grad], [mom], [lr], [wd], momentum,
                        rescale_grad, clip_gradient)
    return weight, mom


@_on_ndarrays(1)
@torch.no_grad()
def mp_sgd_update(weight, grad, weight32, lr, wd=0.0, rescale_grad=1.0,
                  clip_gradient=-1.0):
    """Returns ``weight, weight32``, updated in place."""
    multi_mp_sgd([weight], [grad], [weight32], [lr], [wd], rescale_grad,
                 clip_gradient)
    return weight, weight32


@_on_ndarrays(2)
@torch.no_grad()
def mp_sgd_mom_update(weight, grad, mom, weight32, lr, momentum=0.0,
                      wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """Returns ``weight, mom, weight32``, updated in place."""
    multi_mp_sgd_mom([weight], [grad], [mom], [weight32], [lr], [wd],
                     momentum, rescale_grad, clip_gradient)
    return weight, mom, weight32


@_on_ndarrays(2)
@torch.no_grad()
def adam_update(weight, grad, mean, var, lr, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """Returns ``weight, mean, var``, updated in place."""
    g = grad * rescale_grad
    clip = _clip(clip_gradient)
    if clip > 0:
        g = g.clamp(-clip, clip)
    g = g + wd * weight
    mean.mul_(beta1).add_((1 - beta1) * g)
    var.mul_(beta2).add_((1 - beta2) * torch.square(g))
    weight.sub_(float(lr) * mean / (var.sqrt() + epsilon))
    return weight, mean, var


def _multi_on_ndarrays(stride: int):
    """The ``NDArray`` form of a multi-tensor update over ``w0, g0, (s0,
    ...), w1, ..., lrs, wds`` (``stride`` arrays a weight) that works in
    place on tensors: the weights named by ``out`` (or copies, without
    ``out``) take the new values, the states are updated in place.  One
    call of the kernel wrapper for the whole group."""
    def deco(fn):
        @functools.wraps(fn)
        def op(*data, out=None, num_weights=None, **kwargs):
            if not any(isinstance(a, NDArray) for a in data):
                return fn(*data, num_weights=num_weights, **kwargs)
            groups, lrs, wds = _split(data, stride, num_weights, fn.__name__)
            groups = [[_t(a) for a in grp] for grp in groups]
            n = len(groups[0])
            outs = None if out is None else list(out)
            if outs is not None and len(outs) not in (n, n * (stride - 1)):
                raise MXNetError(f"{fn.__name__}: {len(outs)} outputs for "
                                 f"{n} weights")
            step = 1 if outs is None or len(outs) == n else stride - 1
            ws = [w if outs is not None and _same(outs[i * step], w)
                  else w.clone() for i, w in enumerate(groups[0])]
            flat = [t for row in zip(ws, *groups[1:]) for t in row]
            with torch.no_grad():
                fn(*flat, _host(lrs), _host(wds), **kwargs)
            if outs is None:
                return [NDArray(w) for w in ws]
            # the outputs in the JAX package's order: each weight, then
            # its states past the gradient
            results = [t for row in zip(ws, *groups[2:]) for t in row] \
                if step > 1 else ws
            with torch.no_grad():
                for tgt, src in zip(outs, results):
                    if not _same(tgt, src):
                        _t(tgt).copy_(src)
            return out
        return _reported(op)
    return deco


def _split(data, stride: int, num_weights, name: str):
    arrs, lrs, wds = data[:-2], data[-2], data[-1]
    if not arrs or len(arrs) % stride:
        raise MXNetError(f"{name}: {len(arrs)} tensor inputs is not a "
                         f"multiple of {stride}")
    if num_weights is not None and num_weights != len(arrs) // stride:
        raise MXNetError(f"{name}: num_weights={num_weights} but "
                         f"{len(arrs) // stride} weights given")
    return [list(arrs[i::stride]) for i in range(stride)], lrs, wds


@_multi_on_ndarrays(2)
@torch.no_grad()
def multi_sgd_update(*data, rescale_grad=1.0, clip_gradient=-1.0,
                     num_weights=None) -> List[torch.Tensor]:
    """``w0, g0, w1, g1, ..., lrs, wds``; returns the weights."""
    (ws, gs), lrs, wds = _split(data, 2, num_weights, "multi_sgd_update")
    multi_sgd(ws, gs, lrs, wds, rescale_grad, clip_gradient)
    return ws


@_multi_on_ndarrays(3)
@torch.no_grad()
def multi_sgd_mom_update(*data, momentum=0.0, rescale_grad=1.0,
                         clip_gradient=-1.0,
                         num_weights=None) -> List[torch.Tensor]:
    """``w0, g0, m0, ..., lrs, wds``; returns ``w0, m0, w1, m1, ...``."""
    (ws, gs, ms), lrs, wds = _split(data, 3, num_weights,
                                    "multi_sgd_mom_update")
    multi_sgd_mom(ws, gs, ms, lrs, wds, momentum, rescale_grad,
                  clip_gradient)
    return [t for pair in zip(ws, ms) for t in pair]


@_multi_on_ndarrays(4)
@torch.no_grad()
def multi_mp_sgd_mom_update(*data, momentum=0.0, rescale_grad=1.0,
                            clip_gradient=-1.0,
                            num_weights=None) -> List[torch.Tensor]:
    """``w0, g0, m0, w32_0, ..., lrs, wds``: the momentum update on the
    fp32 masters, each master rounded into its weight in the same pass
    (one launch of the kernel's mixed path per group on the card);
    returns ``w0, m0, w32_0, ...``."""
    (ws, gs, ms, w32s), lrs, wds = _split(data, 4, num_weights,
                                          "multi_mp_sgd_mom_update")
    multi_mp_sgd_mom(ws, gs, ms, w32s, lrs, wds, momentum, rescale_grad,
                     clip_gradient)
    return [t for trio in zip(ws, ms, w32s) for t in trio]


# ---------------------------------------------------------------------------
# The other update operators of the JAX package
# (``mxnet_tpu/ndarray/ops_optimizer.py:67-421``) and ``multi_sum_sq``
# (``mxnet_tpu/ndarray/ops_misc.py:430``): plain torch on the tensors'
# device, as the JAX package leaves them to XLA.  A scalar input (a
# learning rate, LARS's trust ratio, LAMB's ``r1``/``r2``) may be a host
# number or a tensor; a tensor stays on the device and is cast to the
# dtype the update computes in, so the update reads nothing back.


def _scalar(x, like: torch.Tensor):
    """A scalar input as the update uses it: a host number as a float
    (torch takes it in ``like``'s dtype, as JAX's weak types do), a
    tensor cast to ``like``'s dtype on its device (``lr.astype(dtype)``
    in the JAX ops)."""
    x = _t(x)
    if isinstance(x, torch.Tensor):
        return x.to(device=like.device, dtype=like.dtype)
    return float(x)


def _rescaled(grad, rescale_grad, clip_gradient):
    """``grad * rescale_grad``, clipped to ``[-clip, clip]`` when
    ``clip_gradient > 0``."""
    g = grad * rescale_grad
    clip = _clip(clip_gradient)
    return g.clamp(-clip, clip) if clip > 0 else g


def _prep_grad(grad, wd, weight, rescale_grad, clip_gradient):
    """The C++ update kernels' gradient: rescaled, clipped, then plus
    ``wd * weight``."""
    return _rescaled(grad, rescale_grad, clip_gradient) + wd * weight


def _nd_form(updates_weight: bool):
    """The ``NDArray`` form of an operator on tensors (MXNet's
    convention; see the module docstring): with ``updates_weight`` the
    new weight goes to a copy, or to the weight itself under
    ``out=weight``, and the states are updated in place; the result is
    the first output, or ``out`` (one array, or the JAX package's list of
    every output) filled."""
    def deco(fn):
        @functools.wraps(fn)
        def op(*args, out=None, **kwargs):
            if not any(isinstance(a, NDArray) for a in args):
                return fn(*args, **kwargs)
            tensors = [_t(a) for a in args]
            outs = None if out is None else \
                (list(out) if isinstance(out, (list, tuple)) else [out])
            if updates_weight and (outs is None
                                   or not _same(outs[0], tensors[0])):
                tensors[0] = tensors[0].clone()
            with torch.no_grad():
                res = fn(*tensors, **kwargs)
            res = list(res) if isinstance(res, (list, tuple)) else [res]
            if outs is None:
                return NDArray(res[0])
            with torch.no_grad():
                for tgt, src in zip(outs, res):
                    if not _same(tgt, src):
                        _t(tgt).copy_(src)
            return out
        op = _reported(op)
        op.updates_weight = updates_weight
        return op
    return deco


@_nd_form(True)
@torch.no_grad()
def nag_mom_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    """Nesterov momentum: ``mom = momentum * mom + g``, ``weight -= lr *
    (g + momentum * mom)``; returns ``weight, mom``."""
    g = _prep_grad(grad, wd, weight, rescale_grad, clip_gradient)
    mom.mul_(momentum).add_(g)
    weight.sub_(_scalar(lr, weight) * (g + momentum * mom))
    return weight, mom


@_nd_form(True)
@torch.no_grad()
def mp_nag_mom_update(weight, grad, mom, weight32, lr, momentum=0.0,
                      wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """:func:`nag_mom_update` on the fp32 master ``weight32`` from the
    fp32-cast gradient, the master rounded into ``weight``; returns
    ``weight, mom, weight32``."""
    nag_mom_update(weight32, grad.float(), mom, lr, momentum, wd,
                   rescale_grad, clip_gradient)
    weight.copy_(weight32)
    return weight, mom, weight32


@_nd_form(True)
@torch.no_grad()
def ftrl_update(weight, grad, z, n, lr, lamda1=0.01, beta=1.0, wd=0.0,
                rescale_grad=1.0, clip_gradient=-1.0):
    """FTRL-proximal; returns ``weight, z, n``."""
    lr = _scalar(lr, weight)
    g = _rescaled(grad, rescale_grad, clip_gradient)
    n_new = n + torch.square(g)
    sigma = (torch.sqrt(n_new) - torch.sqrt(n)) / lr
    z.copy_(z + g - sigma * weight)
    n.copy_(n_new)
    w = -(z - torch.sign(z) * lamda1) / ((beta + torch.sqrt(n)) / lr + wd)
    weight.copy_(torch.where(torch.abs(z) <= lamda1,
                             torch.zeros_like(weight), w))
    return weight, z, n


@_nd_form(True)
@torch.no_grad()
def signsgd_update(weight, grad, lr, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0):
    """``weight -= lr * sign(g)``; returns ``weight``."""
    g = _prep_grad(grad, wd, weight, rescale_grad, clip_gradient)
    weight.sub_(_scalar(lr, weight) * torch.sign(g))
    return weight


@_nd_form(True)
@torch.no_grad()
def signum_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    """Signum: ``mom = momentum * mom - (1 - momentum) * g``, ``weight =
    (1 - lr * wd_lh) * weight + lr * sign(mom)``; returns ``weight,
    mom``."""
    lr = _scalar(lr, weight)
    g = _prep_grad(grad, wd, weight, rescale_grad, clip_gradient)
    mom.copy_(momentum * mom - (1 - momentum) * g)
    weight.copy_((1 - lr * wd_lh) * weight + lr * torch.sign(mom))
    return weight, mom


def _clip_weights(weight, clip_weights):
    if clip_weights is not None and clip_weights > 0:
        weight.clamp_(-clip_weights, clip_weights)


@_nd_form(True)
@torch.no_grad()
def rmsprop_update(weight, grad, n, lr, gamma1=0.95, epsilon=1e-8, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, clip_weights=-1.0):
    """RMSProp; returns ``weight, n``."""
    g = _prep_grad(grad, wd, weight, rescale_grad, clip_gradient)
    n.copy_(gamma1 * n + (1 - gamma1) * torch.square(g))
    weight.sub_(_scalar(lr, weight) * g / torch.sqrt(n + epsilon))
    _clip_weights(weight, clip_weights)
    return weight, n


@_nd_form(True)
@torch.no_grad()
def rmspropalex_update(weight, grad, n, g_avg, delta, lr, gamma1=0.95,
                       gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0, clip_weights=-1.0):
    """Centered RMSProp (Graves 2013); returns ``weight, n, g_avg,
    delta``."""
    g = _prep_grad(grad, wd, weight, rescale_grad, clip_gradient)
    n.copy_(gamma1 * n + (1 - gamma1) * torch.square(g))
    g_avg.copy_(gamma1 * g_avg + (1 - gamma1) * g)
    delta.copy_(gamma2 * delta - _scalar(lr, weight) * g
                / torch.sqrt(n - torch.square(g_avg) + epsilon))
    weight.add_(delta)
    _clip_weights(weight, clip_weights)
    return weight, n, g_avg, delta


@_nd_form(True)
@torch.no_grad()
def adagrad_update(weight, grad, history, lr, epsilon=1e-7, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    """AdaGrad; returns ``weight, history``."""
    g = _rescaled(grad, rescale_grad, clip_gradient)
    history.add_(torch.square(g))
    weight.sub_(_scalar(lr, weight) * (g / torch.sqrt(history + epsilon)
                                       + wd * weight))
    return weight, history


@_nd_form(True)
@torch.no_grad()
def group_adagrad_update(weight, grad, history, lr, epsilon=1e-5,
                         rescale_grad=1.0, clip_gradient=-1.0):
    """AdaGrad with one history value per row (the mean square over the
    other axes; ``history`` of shape ``(rows, 1, ...)``); returns
    ``weight, history``."""
    g = _rescaled(grad, rescale_grad, clip_gradient)
    sq = torch.square(g)
    history.add_(sq.mean(dim=tuple(range(1, g.dim())), keepdim=True)
                 if g.dim() > 1 else sq)
    weight.sub_(_scalar(lr, weight) * g / (torch.sqrt(history) + epsilon))
    return weight, history


@_nd_form(True)
@torch.no_grad()
def adamw_update(weight, grad, mean, var, lr, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, wd=0.0, eta=1.0, rescale_grad=1.0,
                 clip_gradient=-1.0):
    """Adam with decoupled weight decay: ``weight -= eta * (lr * mean /
    (sqrt(var) + epsilon) + wd * weight)``; returns ``weight, mean,
    var``."""
    g = _rescaled(grad, rescale_grad, clip_gradient)
    mean.copy_(beta1 * mean + (1 - beta1) * g)
    var.copy_(beta2 * var + (1 - beta2) * torch.square(g))
    weight.sub_(eta * (_scalar(lr, weight) * mean
                       / (torch.sqrt(var) + epsilon) + wd * weight))
    return weight, mean, var


@_nd_form(True)
@torch.no_grad()
def mp_adamw_update(weight, grad, mean, var, weight32, lr, beta1=0.9,
                    beta2=0.999, epsilon=1e-8, wd=0.0, eta=1.0,
                    rescale_grad=1.0, clip_gradient=-1.0):
    """:func:`adamw_update` on the fp32 master from the fp32-cast
    gradient, the master rounded into ``weight``; returns ``weight, mean,
    var, weight32``."""
    adamw_update(weight32, grad.float(), mean, var, lr, beta1, beta2,
                 epsilon, wd, eta, rescale_grad, clip_gradient)
    weight.copy_(weight32)
    return weight, mean, var, weight32


def _norm32(x: torch.Tensor) -> torch.Tensor:
    """The L2 norm in fp32, as a 0-d tensor on ``x``'s device."""
    return torch.sqrt(torch.sum(torch.square(x.float())))


@_nd_form(False)
@torch.no_grad()
def lars_trust(weight, grad, wd, eta=0.001, epsilon=1e-8,
               rescale_grad=1.0):
    """LARS's layer-wise trust ratio ``eta * |w| / (|g * rescale| + wd *
    |w| + epsilon)`` (1 where a norm is 0), a 0-d fp32 tensor on the
    weight's device; ``wd`` is a number or a tensor."""
    w_norm = _norm32(weight)
    g_norm = _norm32(grad * rescale_grad)
    trust = eta * w_norm / (g_norm + _scalar(wd, w_norm) * w_norm + epsilon)
    return torch.where((w_norm > 0) & (g_norm > 0), trust,
                       torch.ones_like(trust))


@_nd_form(False)
@torch.no_grad()
def multi_lars(lrs, weights_sum_sq, grads_sum_sq, wds, eta=0.001, eps=1e-8,
               rescale_grad=1.0):
    """The trust ratios of many layers from their sums of squares
    (:func:`multi_sum_sq`): ``lrs`` scaled by each layer's ratio."""
    w_norm = torch.sqrt(weights_sum_sq)
    g_norm = torch.sqrt(grads_sum_sq) * rescale_grad
    trust = eta * w_norm / (g_norm + wds * w_norm + eps)
    trust = torch.where((w_norm > 0) & (g_norm > 0), trust,
                        torch.ones_like(trust))
    return lrs * trust


@_nd_form(False)
@torch.no_grad()
def multi_sum_sq(*arrays, num_arrays=None):
    """The sum of squares of each array, in fp32, as one vector."""
    if num_arrays is not None and num_arrays != len(arrays):
        raise MXNetError(f"multi_sum_sq: num_arrays={num_arrays} but "
                         f"{len(arrays)} arrays given")
    return torch.stack([torch.sum(torch.square(a.float())) for a in arrays])


@_nd_form(True)
@torch.no_grad()
def ftml_update(weight, grad, d, v, z, lr, beta1=0.6, beta2=0.999,
                epsilon=1e-8, t=1, wd=0.0, rescale_grad=1.0, clip_grad=-1.0):
    """Follow The Moving Leader at step ``t``; returns ``weight, d, v,
    z``."""
    g = _prep_grad(grad, wd, weight, rescale_grad, clip_grad)
    v.copy_(beta2 * v + (1 - beta2) * g * g)
    lr = _scalar(lr, weight)
    if isinstance(lr, torch.Tensor):
        coef = (1 - beta1 ** t) / lr
    else:        # the JAX op's fp32 quotient of the two numbers
        coef = float(np.float32(1 - beta1 ** t) / np.float32(lr))
    d_new = coef * (torch.sqrt(v / (1 - beta2 ** t)) + epsilon)
    sigma = d_new - beta1 * d
    z.copy_(beta1 * z + (1 - beta1) * g - sigma * weight)
    d.copy_(d_new)
    weight.copy_(-z / d)
    return weight, d, v, z


@_nd_form(False)
@torch.no_grad()
def lamb_update_phase1(weight, grad, mean, var, beta1=0.9, beta2=0.999,
                       epsilon=1e-6, t=1, bias_correction=True, wd=0.0,
                       rescale_grad=1.0, clip_gradient=-1.0):
    """LAMB's first phase: the fp32 moments updated in place and the
    direction ``m_hat / (sqrt(v_hat) + epsilon) + wd * weight`` in the
    weight's dtype (bias-corrected at step ``t``); returns ``direction,
    mean, var``."""
    g = _rescaled(grad.float(), rescale_grad, clip_gradient)
    mean.copy_(beta1 * mean + (1 - beta1) * g)
    var.copy_(beta2 * var + (1 - beta2) * g * g)
    m_hat, v_hat = mean, var
    if bias_correction:
        m_hat = mean / (1 - beta1 ** t)
        v_hat = var / (1 - beta2 ** t)
    direction = m_hat / (torch.sqrt(v_hat) + epsilon) + wd * weight.float()
    return direction.to(weight.dtype), mean, var


def _bound(x):
    return -1.0 if x is None else x


@_nd_form(True)
@torch.no_grad()
def lamb_update_phase2(weight, g, r1, r2, lr, lower_bound=-1.0,
                       upper_bound=-1.0):
    """LAMB's second phase: ``weight -= lr * ratio * g`` with the trust
    ratio ``r1 / r2`` (``r1 = |w|`` clamped to the bounds, ``r2 =
    |direction|``; 1 where either is 0); ``r1``, ``r2`` and ``lr`` may
    be tensors on the device.  Returns ``weight``."""
    r1, r2 = (torch.as_tensor(_t(r), dtype=torch.float32,
                              device=weight.device) for r in (r1, r2))
    if _bound(lower_bound) > 0:
        r1 = torch.clamp(r1, min=lower_bound)
    if _bound(upper_bound) > 0:
        r1 = torch.clamp(r1, max=upper_bound)
    ratio = torch.where((r1 > 0) & (r2 > 0), r1 / r2, torch.ones_like(r1))
    weight.sub_(_scalar(lr, weight) * ratio.to(weight.dtype) * g)
    return weight


@_nd_form(False)
@torch.no_grad()
def mp_lamb_update_phase1(weight, grad, mean, var, weight32, beta1=0.9,
                          beta2=0.999, epsilon=1e-6, t=1,
                          bias_correction=True, wd=0.0, rescale_grad=1.0,
                          clip_gradient=-1.0):
    """:func:`lamb_update_phase1` from the fp32 master: an fp32
    direction; returns ``direction, mean, var``."""
    return lamb_update_phase1(weight32, grad, mean, var, beta1, beta2,
                              epsilon, t, bias_correction, wd, rescale_grad,
                              clip_gradient)


@_nd_form(True)
@torch.no_grad()
def mp_lamb_update_phase2(weight, g, r1, r2, weight32, lr, lower_bound=-1.0,
                          upper_bound=-1.0):
    """:func:`lamb_update_phase2` on the fp32 master, the master rounded
    into ``weight``; returns ``weight, weight32``."""
    lamb_update_phase2(weight32, g, r1, r2, lr, lower_bound, upper_bound)
    weight.copy_(weight32)
    return weight, weight32


# the registry's names (the JAX package's; ``_contrib_*`` with their
# short aliases) for the operators above.  Through ``invoke`` an operator
# takes MXNet's ``NDArray`` convention on any input: the states in place,
# the new weight as the result.
_REGISTERED = (
    ("nag_mom_update", nag_mom_update, ()),
    ("mp_nag_mom_update", mp_nag_mom_update, ()),
    ("ftrl_update", ftrl_update, ()),
    ("signsgd_update", signsgd_update, ()),
    ("signum_update", signum_update, ()),
    ("rmsprop_update", rmsprop_update, ()),
    ("rmspropalex_update", rmspropalex_update, ()),
    ("adagrad_update", adagrad_update, ()),
    ("_contrib_group_adagrad_update", group_adagrad_update,
     ("group_adagrad_update",)),
    ("_contrib_adamw_update", adamw_update, ("adamw_update",)),
    ("_contrib_mp_adamw_update", mp_adamw_update, ("mp_adamw_update",)),
    ("lars_trust", lars_trust, ()),
    ("multi_lars", multi_lars, ()),
    ("ftml_update", ftml_update, ()),
    ("lamb_update_phase1", lamb_update_phase1, ()),
    ("lamb_update_phase2", lamb_update_phase2, ()),
    ("mp_lamb_update_phase1", mp_lamb_update_phase1, ()),
    ("mp_lamb_update_phase2", mp_lamb_update_phase2, ()),
    ("multi_sum_sq", multi_sum_sq, ()),
)


def _maker(op):
    def maker(**kwargs):
        def fn(*tensors):
            return op.unreported(*[NDArray(t) for t in tensors],
                                 **kwargs)._data
        return fn
    maker.__doc__ = op.__doc__
    return maker


for _name, _op, _aliases in _REGISTERED:
    register_op(_name, _maker(_op), aliases=_aliases)


def _nd_form_maker(op):
    """The registry's form of an SGD-family or Adam frontend: the
    frontend's ``NDArray`` form on the op's tensors (the states updated in
    place, the new weights returned; MXNet's ``optimizer_op.cc``).  The
    ``mx.nd`` attributes stay the hand-written frontends, and
    ``gluon.Trainer`` calls the kernel wrappers directly, so the registry
    is on neither path."""
    def maker(**kwargs):
        def fn(*tensors):
            res = op.unreported(*[NDArray(t) for t in tensors], **kwargs)
            if isinstance(res, (list, tuple)):
                return [r._data for r in res]
            return res._data
        return fn
    maker.__doc__ = op.__doc__
    return maker


# the SGD family and Adam under the JAX package's names (the multi-tensor
# ones also under its ``preloaded_`` aliases: the rates arrive as inputs)
for _name, _op, _aliases in (
        ("sgd_update", sgd_update, ()),
        ("sgd_mom_update", sgd_mom_update, ()),
        ("mp_sgd_update", mp_sgd_update, ()),
        ("mp_sgd_mom_update", mp_sgd_mom_update, ()),
        ("adam_update", adam_update, ()),
        ("multi_sgd_update", multi_sgd_update,
         ("preloaded_multi_sgd_update",)),
        ("multi_sgd_mom_update", multi_sgd_mom_update,
         ("preloaded_multi_sgd_mom_update",)),
        ("multi_mp_sgd_mom_update", multi_mp_sgd_mom_update,
         ("preloaded_multi_mp_sgd_mom_update",))):
    register_op(_name, _nd_form_maker(_op), aliases=_aliases)
