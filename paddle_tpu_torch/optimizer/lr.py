"""Learning-rate schedulers (counterpart of ``paddle_tpu/optimizer/lr.py``).

Host-side state, one float per step, with the JAX package's semantics:
the scheduler computes its first rate at construction (``last_epoch``
becomes 0), :meth:`LRScheduler.step` advances it, and the optimizer reads
``last_lr``. The train step never steps the scheduler; the caller does.
"""
from __future__ import annotations

import math


class LRScheduler:
    def __init__(self, learning_rate=0.1, last_epoch=-1, verbose=False):
        self.base_lr = float(learning_rate)
        self.last_epoch = last_epoch
        self.verbose = verbose
        self.last_lr = self.base_lr
        self.step()

    def get_lr(self):
        raise NotImplementedError

    def step(self, epoch=None):
        if epoch is None:
            self.last_epoch += 1
        else:
            self.last_epoch = epoch
        self.last_lr = self.get_lr()

    def __call__(self):
        return self.last_lr

    def state_dict(self):
        return {
            k: v
            for k, v in self.__dict__.items()
            if isinstance(v, (int, float, bool, str, list))
        }

    def set_state_dict(self, state):
        self.__dict__.update(state)

    set_dict = set_state_dict


class LinearWarmup(LRScheduler):
    """Linear ramp from ``start_lr`` to ``end_lr`` over ``warmup_steps``,
    then ``learning_rate`` (a float, or a scheduler stepped from then
    on) (``lr.py:116``)."""

    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr,
                 last_epoch=-1, verbose=False):
        self.lr_after = learning_rate  # float or LRScheduler
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr
        self.end_lr = end_lr
        super().__init__(
            learning_rate if isinstance(learning_rate, float) else end_lr,
            last_epoch, verbose,
        )

    def get_lr(self):
        if self.last_epoch < self.warmup_steps:
            return (self.end_lr - self.start_lr) * (
                self.last_epoch / float(self.warmup_steps)
            ) + self.start_lr
        if isinstance(self.lr_after, LRScheduler):
            return self.lr_after.last_lr
        return float(self.lr_after)

    def step(self, epoch=None):
        if isinstance(self.lr_after, LRScheduler) \
                and self.last_epoch >= self.warmup_steps:
            self.lr_after.step(epoch)
        super().step(epoch)


class CosineAnnealingDecay(LRScheduler):
    """``eta_min + (base - eta_min) * (1 + cos(pi * epoch / T_max)) / 2``
    (``lr.py:196``)."""

    def __init__(self, learning_rate, T_max, eta_min=0, last_epoch=-1,
                 verbose=False):
        self.T_max = T_max
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return (
            self.eta_min
            + (self.base_lr - self.eta_min)
            * (1 + math.cos(math.pi * self.last_epoch / self.T_max))
            / 2
        )
