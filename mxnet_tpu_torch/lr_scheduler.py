"""Learning-rate schedules: ``mx.lr_scheduler``.

Counterpart of ``mxnet_tpu/lr_scheduler.py`` (:13-118), MXNet's
schedulers with linear or constant warmup: ``FactorScheduler`` (the rate
times ``factor`` every ``step`` updates, floored at ``stop_factor_lr``),
``MultiFactorScheduler`` (times ``factor`` past each of ``step``'s
update counts), ``PolyScheduler`` and ``CosineScheduler`` (from
``base_lr`` down to ``final_lr`` at ``max_update``).  A scheduler is
called with the optimizer's ``num_update`` and returns the rate.

As in MXNet, the optimizer sets ``base_lr`` to its ``learning_rate``
when it takes the scheduler; the warmup's final rate and the poly and
cosine schedules' starting rate are fixed when the scheduler is made,
so give ``base_lr`` to the scheduler too.  Factor and MultiFactor are
stateful: they advance ``count`` (and the index of the next step) and
scale ``base_lr`` as ``num_update`` passes their steps, in ``while``
loops, so a fresh scheduler called at a resumed ``num_update`` catches
up to the rate of the run it resumes.
"""
from __future__ import annotations

import math

from .base import MXNetError

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler",
           "PolyScheduler", "CosineScheduler"]


class LRScheduler:
    """Base scheduler: the warmup from ``warmup_begin_lr`` to ``base_lr``
    over the first ``warmup_steps`` updates, ``linear`` or
    ``constant``."""

    def __init__(self, base_lr=0.01, warmup_steps=0, warmup_begin_lr=0,
                 warmup_mode="linear"):
        self.base_lr = base_lr
        self.warmup_steps = warmup_steps
        self.warmup_begin_lr = warmup_begin_lr
        self.warmup_final_lr = base_lr
        self.warmup_mode = warmup_mode

    def get_warmup_lr(self, num_update: int) -> float:
        if num_update >= self.warmup_steps:
            raise MXNetError(f"update {num_update} is past the "
                             f"{self.warmup_steps} warmup steps")
        if self.warmup_mode == "linear":
            inc = (self.warmup_final_lr - self.warmup_begin_lr) * \
                num_update / self.warmup_steps
            return self.warmup_begin_lr + inc
        if self.warmup_mode == "constant":
            return self.warmup_begin_lr
        raise MXNetError(f"bad warmup_mode {self.warmup_mode}")

    def __call__(self, num_update: int) -> float:
        raise NotImplementedError


class FactorScheduler(LRScheduler):
    def __init__(self, step, factor=1.0, stop_factor_lr=1e-8, base_lr=0.01,
                 warmup_steps=0, warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        if step < 1:
            raise MXNetError("step must be >= 1")
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr
        self.count = 0

    def __call__(self, num_update: int) -> float:
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        while num_update > self.count + self.step:
            self.count += self.step
            self.base_lr *= self.factor
            if self.base_lr < self.stop_factor_lr:
                self.base_lr = self.stop_factor_lr
        return self.base_lr


class MultiFactorScheduler(LRScheduler):
    def __init__(self, step, factor=1.0, base_lr=0.01, warmup_steps=0,
                 warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        if not all(step[i] < step[i + 1] for i in range(len(step) - 1)):
            raise MXNetError("steps must be increasing")
        self.step = list(step)
        self.cur_step_ind = 0
        self.factor = factor
        self.count = 0

    def __call__(self, num_update: int) -> float:
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        while self.cur_step_ind <= len(self.step) - 1:
            if num_update > self.step[self.cur_step_ind]:
                self.count = self.step[self.cur_step_ind]
                self.cur_step_ind += 1
                self.base_lr *= self.factor
            else:
                return self.base_lr
        return self.base_lr


class PolyScheduler(LRScheduler):
    def __init__(self, max_update, base_lr=0.01, pwr=2, final_lr=0,
                 warmup_steps=0, warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        self.power = pwr
        self.base_lr_orig = base_lr
        self.max_update = max_update
        self.final_lr = final_lr
        self.max_steps = max_update - warmup_steps

    def __call__(self, num_update: int) -> float:
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        if num_update <= self.max_update:
            frac = 1 - (num_update - self.warmup_steps) / self.max_steps
            return self.final_lr + (self.base_lr_orig - self.final_lr) * \
                (frac ** self.power)
        return self.final_lr


class CosineScheduler(LRScheduler):
    def __init__(self, max_update, base_lr=0.01, final_lr=0,
                 warmup_steps=0, warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        self.base_lr_orig = base_lr
        self.max_update = max_update
        self.final_lr = final_lr
        self.max_steps = max_update - warmup_steps

    def __call__(self, num_update: int) -> float:
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        if num_update <= self.max_update:
            frac = (num_update - self.warmup_steps) / self.max_steps
            return self.final_lr + (self.base_lr_orig - self.final_lr) * \
                (1 + math.cos(math.pi * frac)) / 2
        return self.final_lr
