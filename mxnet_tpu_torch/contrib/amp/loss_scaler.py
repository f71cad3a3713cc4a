"""Loss scaling (reference: python/mxnet/contrib/amp/loss_scaler.py).

Counterpart of ``mxnet_tpu/contrib/amp/loss_scaler.py``.  Scale up the
loss so small gradients survive low-precision storage; on overflow skip
the step and halve the scale; after ``scale_window`` clean steps double
it.  bf16 shares fp32's exponent range, so under bf16 the scaler mostly
idles; it earns its keep under fp16.
"""
from __future__ import annotations

import torch

__all__ = ["LossScaler", "DynamicLossScaler", "StaticLossScaler"]


class LossScaler:
    loss_scale = 1.0

    def has_overflow(self, params) -> bool:
        """True if any gradient element is non-finite.  Elementwise: a
        finite fp16 gradient can SUM to inf, which must not count.  One
        host read for all the gradients."""
        finite = [torch.isfinite(g).all() for p in params
                  for g in p.list_grad()]
        if not finite:
            return False
        return not bool(torch.stack(finite).all())

    def update_scale(self, overflow: bool) -> None:
        pass


class StaticLossScaler(LossScaler):
    def __init__(self, init_scale: float = 2 ** 16):
        self.loss_scale = float(init_scale)


class DynamicLossScaler(LossScaler):
    def __init__(self, init_scale: float = 2 ** 16,
                 scale_factor: float = 2.0, scale_window: int = 2000):
        self.loss_scale = float(init_scale)
        self.scale_factor = scale_factor
        self.scale_window = scale_window
        self._unskipped = 0

    def update_scale(self, overflow: bool) -> None:
        if overflow:
            self.loss_scale = max(1.0, self.loss_scale / self.scale_factor)
            self._unskipped = 0
        else:
            self._unskipped += 1
            if self._unskipped >= self.scale_window:
                self.loss_scale *= self.scale_factor
                self._unskipped = 0
