"""The long tail of the registry: ``lars_update``.

Counterpart of ``mxnet_tpu/ndarray/ops_tail.py`` (``lars_update``
:204-223), for the ops of that file the port has so far.  One LARS step
on one tensor: the gradient rescaled and clipped in float32, the trust
ratio ``eta * |w| / (|g| + wd * |w| + epsilon)`` in float32 (1 where
either norm is 0), then a plain SGD step at ``trust * lr``, computed in
float32 and rounded to the weight's dtype.  The JAX package computes it
in XLA outside any Pallas kernel; here it is torch code, and the trust
ratio stays on the device (no host read).  The multi-tensor LARS path
is ``multi_lars`` (``ops_optimizer.py``).
"""
from __future__ import annotations

import torch

from .register import register_op


def lars_update_maker(lr, eta=0.001, wd=0.0, rescale_grad=1.0,
                      clip_gradient=-1.0, epsilon=1e-9):
    def fn(weight, grad):
        w = weight.float()
        g = grad.float() * rescale_grad
        if clip_gradient > 0:
            g = g.clamp(-clip_gradient, clip_gradient)
        wn = w.square().sum().sqrt()
        gn = g.square().sum().sqrt()
        trust = torch.where((wn > 0) & (gn > 0),
                            eta * wn / (gn + wd * wn + epsilon),
                            torch.ones_like(wn))
        return (w - trust * lr * (g + wd * w)).to(weight.dtype)
    return fn


register_op("lars_update", lars_update_maker)
