"""Optimizer update operators, in place on their weight and state
tensors.

Counterpart of the SGD family of ``mxnet_tpu/ndarray/ops_optimizer.py``:

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
folds the bias correction into ``lr``.

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
from typing import List

import torch

from ..base import MXNetError
from ..engine import engine as _engine
from ..kernels.multi_sgd import (_clip, multi_mp_sgd, multi_mp_sgd_mom,
                                 multi_sgd, multi_sgd_mom,
                                 multi_sgd_mom_plain, multi_sgd_plain)
from .ndarray import NDArray


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


def _same(a, b: torch.Tensor) -> bool:
    a = _t(a)
    return (a.data_ptr() == b.data_ptr() and a.shape == b.shape
            and a.dtype == b.dtype and a.stride() == b.stride())


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
            scalars = [_host(a)[0] for a in args[k:k + n_host]]
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
        return op
    return deco

__all__ = ["sgd_update", "sgd_mom_update", "mp_sgd_update",
           "mp_sgd_mom_update", "multi_sgd_update", "multi_sgd_mom_update",
           "multi_mp_sgd_mom_update", "adam_update"]


@_on_ndarrays(0)
@torch.no_grad()
def sgd_update(weight, grad, lr, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0):
    multi_sgd_plain([weight], [grad], [lr], [wd], rescale_grad,
                    clip_gradient)
    return weight


@_on_ndarrays(1)
@torch.no_grad()
def sgd_mom_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
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
        return op
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
