"""Loss scaling (counterpart of ``paddle_tpu/amp/grad_scaler.py``).

The eager ``GradScaler``: ``scale(loss)`` multiplies by the scale,
``unscale_(opt)`` checks every gradient for a non-finite value (one
``mt_sumsq`` pass on the card, read back) and multiplies them by ``1 /
scale``, ``step(opt)`` steps unless a value was non-finite, ``update()``
grows the scale after ``incr_every_n_steps`` good steps and shrinks it,
floored at 1, after ``decr_every_n_nan_or_inf`` bad ones (Python floats,
as in the JAX package). Given to ``jit.CompiledTrainStep(scaler=...)``, the
same state is updated inside the step instead, by the JAX step's fp32
formulas (``trainer.py:527-556``). The port's kernels take fp32 and bf16,
so on the card the scaler runs under bf16 O1.
"""
from __future__ import annotations

from ..kernels import fused_adam as fa


class GradScaler:
    def __init__(self, enable=True, init_loss_scaling=2.0**15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled = False

    def scale(self, var):
        if not self._enable:
            return var
        return var * self._scale

    def _grads_finite(self, optimizer):
        grads = [p.grad for _, p in optimizer._all_params()
                 if p.grad is not None]
        by_device = {}
        for g in grads:
            by_device.setdefault(g.device, []).append(g)
        return all(fa.grad_sumsq(gs).finite() for gs in by_device.values())

    def unscale_(self, optimizer):
        if not self._enable or self._unscaled:
            return  # a second unscale would divide by the scale twice
        self._found_inf = not self._grads_finite(optimizer)
        inv = 1.0 / self._scale
        for _, p in optimizer._all_params():
            if p.grad is not None:
                p.grad = p.grad * inv
        self._unscaled = True

    def step(self, optimizer):
        """Does not update the scale: call :meth:`update` after (or use
        :meth:`minimize`, which does both)."""
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()

    def minimize(self, optimizer, scaled_loss):
        self.step(optimizer)
        self.update()

    def update(self):
        self._unscaled = False
        if not (self._enable and self._dynamic):
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_init_loss_scaling(self):
        return self._scale

    def set_init_loss_scaling(self, v):
        self._scale = float(v)

    def state_dict(self):
        return {
            "scale": self._scale,
            "incr_ratio": self._incr_ratio,
            "decr_ratio": self._decr_ratio,
            "incr_count": self._good_steps,
            "decr_count": self._bad_steps,
        }

    def load_state_dict(self, state):
        self._scale = state.get("scale", self._scale)
        self._good_steps = state.get("incr_count", 0)
        self._bad_steps = state.get("decr_count", 0)


AmpScaler = GradScaler
