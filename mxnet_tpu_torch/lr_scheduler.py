"""Learning-rate schedules (mxnet_tpu/lr_scheduler.py): closed-form,
stateless maps from the optimizer's update counter to a learning rate.
Ported: FactorScheduler and MultiFactorScheduler; Poly and Cosine wait.
"""
from __future__ import annotations

import bisect
import logging


class LRScheduler:
    """Base: subclasses implement `_value(num_update)` as a pure
    function of the counter and construction params; `base_lr` may be
    re-assigned at any time (the Optimizer does so at init).

    Milestone schedules (`_log_changes = True`) log each decay;
    continuous schedules (Poly/Cosine) change every step and stay
    quiet."""

    _log_changes = False

    def __init__(self, base_lr=0.01):
        self.base_lr = base_lr
        self._logged = None

    def _value(self, num_update):
        raise NotImplementedError

    def __call__(self, num_update):
        lr = self._value(num_update)
        if self._log_changes and lr != self._logged:
            if self._logged is not None:
                logging.info("lr schedule: update %d -> lr %.5e",
                             num_update, lr)
            self._logged = lr
        return lr


class FactorScheduler(LRScheduler):
    """Geometric decay: lr = base_lr * factor^(decays), one decay per
    `step` updates, floored at `stop_factor_lr`."""

    _log_changes = True

    def __init__(self, step, factor=1.0, stop_factor_lr=1e-8):
        super().__init__()
        if step < 1:
            raise ValueError("FactorScheduler: step must be >= 1")
        if factor > 1.0:
            raise ValueError("FactorScheduler: factor must be <= 1")
        self.step = int(step)
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr

    def _value(self, num_update):
        decays = max(0, (int(num_update) - 1) // self.step)
        return max(self.base_lr * self.factor ** decays,
                   self.stop_factor_lr)


class MultiFactorScheduler(LRScheduler):
    """Milestone decay: lr = base_lr * factor^k where k counts the
    milestones already passed (milestone m is passed once
    num_update > m)."""

    _log_changes = True

    def __init__(self, step, factor=1):
        super().__init__()
        if not isinstance(step, list) or not step:
            raise ValueError(
                "MultiFactorScheduler: step must be a non-empty list")
        if any(s < 1 for s in step):
            raise ValueError("MultiFactorScheduler: milestones must be >= 1")
        if any(b <= a for a, b in zip(step, step[1:])):
            raise ValueError(
                "MultiFactorScheduler: milestones must strictly increase")
        if factor > 1.0:
            raise ValueError("MultiFactorScheduler: factor must be <= 1")
        self.step = list(step)
        self.factor = factor

    def _value(self, num_update):
        passed = bisect.bisect_left(self.step, int(num_update))
        return self.base_lr * self.factor ** passed
