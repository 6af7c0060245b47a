"""Optimizers: ``Optimizer``, ``Adam`` and ``AdamW`` (counterpart of
``paddle_tpu/optimizer/optimizer.py``, ``:129``, ``:372`` and ``:459``).

The update keeps the JAX package's fp32 op order (``_adam_update``,
``:44-56``) exactly: decoupled decay multiplies the fp32 parameter by
``1 - lr * weight_decay`` before the step is taken, the step is
``lr * mhat / (sqrt(vhat) + eps)`` with the bias corrections
``1 - beta ** t`` at a float step count ``t``, and the result is cast
back once. (``torch.optim.AdamW`` computes ``lr / bc1 * m / (sqrt(v) /
sqrt(bc2) + eps)`` and drifts from it at fp32.) The scalars are rounded
to fp32 before they meet a tensor, as the JAX step's fp32 scalars are.
Moments are fp32 tensors on the parameter's device, updated in place.

``parameters`` is a list of tensors, of ``(name, tensor)`` pairs (what
``net.named_parameters()`` yields), or of group dicts ``{"params": [...],
"learning_rate": multiplier, "weight_decay": coeff}``. A parameter's
name (``param_<i>`` when none is given) keys its state and is what
``apply_decay_param_fun`` receives.
"""
from __future__ import annotations

import numbers

import numpy as np
import torch

from .lr import LRScheduler

_F32 = np.float32


def _f32(x):
    """A Python float holding ``x`` rounded to fp32 (exact in a tensor op
    with an fp32 tensor)."""
    return float(_F32(x))


@torch.no_grad()
def adam_update_(p, m, v, g, lr, beta1, beta2, eps, t, weight_decay,
                 decoupled):
    """One Adam/AdamW step in place on ``p`` (any float dtype) and its
    fp32 moments ``m``, ``v``, in the op order of ``_adam_update``."""
    lr, beta1, beta2 = _F32(lr), _F32(beta1), _F32(beta2)
    t, wd = _F32(t), _F32(weight_decay)
    g32 = g.float()
    p32 = p.float()
    if not decoupled and wd:
        g32 = g32 + float(wd) * p32
    m2 = float(beta1) * m + float(_F32(1) - beta1) * g32
    v2 = float(beta2) * v + float(_F32(1) - beta2) * torch.square(g32)
    mhat = m2 / float(_F32(1) - np.power(beta1, t))
    vhat = v2 / float(_F32(1) - np.power(beta2, t))
    step = float(lr) * mhat / (torch.sqrt(vhat) + _f32(eps))
    if decoupled:
        p32 = p32 * float(_F32(1) - lr * wd)
    p.copy_(p32 - step)
    m.copy_(m2)
    v.copy_(v2)


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        op = type(self).__name__
        if parameters is None:
            raise ValueError(f"{op}: parameters must be provided (an "
                             "explicit parameter list, as in paddle)")
        if isinstance(learning_rate, numbers.Real):
            if float(learning_rate) < 0:
                raise ValueError(f"{op}: learning_rate expected >= 0, got "
                                 f"{learning_rate}")
        elif not isinstance(learning_rate, LRScheduler):
            raise TypeError(f"{op}: learning_rate expected a float or an "
                            f"LRScheduler, got "
                            f"{type(learning_rate).__name__}")
        if isinstance(weight_decay, numbers.Real) and weight_decay < 0:
            raise ValueError(f"{op}: weight_decay expected >= 0, got "
                             f"{weight_decay}")
        if weight_decay is not None and \
                not isinstance(weight_decay, numbers.Real):
            raise NotImplementedError(
                f"{op}: weight_decay must be a float; L1Decay/L2Decay "
                "regularizer objects are not ported")
        self._lr = learning_rate
        self._param_groups, self._names = self._build_groups(parameters)
        self._grad_clip = grad_clip
        self._weight_decay = weight_decay
        self._accumulators = {}
        self._step_count = 0

    # ----------------------------------------------------------- structure
    @staticmethod
    def _build_groups(parameters):
        items = list(parameters)
        groups = ([dict(g) for g in items]
                  if items and isinstance(items[0], dict)
                  else [{"params": items}])
        names, i = {}, 0
        for g in groups:
            params = []
            for entry in g["params"]:
                if isinstance(entry, tuple):
                    pname, p = entry
                else:
                    pname, p = f"param_{i}", entry
                if not isinstance(p, torch.Tensor):
                    raise TypeError(f"parameters expected tensors, got "
                                    f"{type(p).__name__}")
                names[id(p)] = pname
                params.append(p)
                i += 1
            g["params"] = params
        return groups, names

    def _all_params(self):
        for g in self._param_groups:
            for p in g["params"]:
                yield g, p

    def param_name(self, p):
        return self._names[id(p)]

    # ----------------------------------------------------------------- lr
    def get_lr(self):
        if isinstance(self._lr, LRScheduler):
            return float(self._lr.last_lr)
        return float(self._lr)

    def set_lr(self, value):
        if isinstance(self._lr, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._lr = float(value)

    def set_lr_scheduler(self, scheduler):
        self._lr = scheduler

    # -------------------------------------------------------------- update
    def _decay_value(self, group, p):
        """The weight-decay coefficient of ``p``: its group's, else the
        optimizer's (0.0 when neither is set)."""
        wd = group.get("weight_decay", self._weight_decay)
        return 0.0 if wd is None else float(wd)

    def lr_multiplier(self, group):
        # a group's 'learning_rate' multiplies the scheduled rate
        return float(group.get("learning_rate", 1.0))

    def step(self):
        """The eager step: parameters without a gradient are skipped,
        the gradients are clipped, then each parameter is updated."""
        params_grads = [(p, p.grad, g) for g, p in self._all_params()
                        if p.grad is not None]
        if not params_grads:
            return
        grads = [gr for _, gr, _ in params_grads]
        if self._grad_clip is not None:
            grads = self._grad_clip.clip(grads)
        self._step_count += 1
        lr = self.get_lr()
        for (p, _, group), gr in zip(params_grads, grads):
            self._update_param(p, gr, lr * self.lr_multiplier(group), group)

    def _update_param(self, p, g, lr, group):
        raise NotImplementedError

    def clear_grad(self, set_to_zero=False):
        for _, p in self._all_params():
            if set_to_zero and p.grad is not None:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    # --------------------------------------------------------------- state
    def _acc(self, p, name):
        key = (self._names[id(p)], name)
        if key not in self._accumulators:
            self._accumulators[key] = torch.zeros_like(
                p, dtype=torch.float32, memory_format=torch.contiguous_format)
        return self._accumulators[key]

    def state_dict(self):
        sd = {f"{pname}__{acc}": v
              for (pname, acc), v in self._accumulators.items()}
        sd["@step_count"] = self._step_count
        if isinstance(self._lr, LRScheduler):
            sd["LR_Scheduler"] = self._lr.state_dict()
        return sd

    def set_state_dict(self, state):
        by_name = {self._names[id(p)]: p for _, p in self._all_params()}
        self._step_count = int(state.get("@step_count", 0))
        if "LR_Scheduler" in state and isinstance(self._lr, LRScheduler):
            self._lr.set_state_dict(state["LR_Scheduler"])
        for k, v in state.items():
            if k in ("@step_count", "LR_Scheduler") or "__" not in k:
                continue
            pname, acc = k.rsplit("__", 1)
            p = by_name.get(pname)
            if p is not None:
                self._accumulators[(pname, acc)] = torch.as_tensor(
                    np.asarray(v) if not isinstance(v, torch.Tensor) else v,
                    dtype=torch.float32, device=p.device).clone()

    set_dict = set_state_dict


class Adam(Optimizer):
    _decoupled = False

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1 = beta1
        self._beta2 = beta2
        self._eps = epsilon

    def decay_of(self, group, p):
        """The weight decay ``p`` gets under this optimizer."""
        return self._decay_value(group, p)

    def _update_param(self, p, g, lr, group):
        adam_update_(p, self._acc(p, "moment1"), self._acc(p, "moment2"), g,
                     lr, self._beta1, self._beta2, self._eps,
                     self._step_count, self.decay_of(group, p),
                     self._decoupled)


class AdamW(Adam):
    """Decoupled weight decay (paddle.optimizer.AdamW).
    ``apply_decay_param_fun(name)`` returning False exempts a parameter
    from the optimizer-level decay (a group-level ``weight_decay`` still
    applies, as in the JAX trainer)."""

    _decoupled = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=0.01,
                 apply_decay_param_fun=None, grad_clip=None, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, name=name)
        self._apply_decay_fun = apply_decay_param_fun

    def decay_of(self, group, p):
        if self._apply_decay_fun is not None and \
                not self._apply_decay_fun(self.param_name(p)):
            wd = group.get("weight_decay")
            return 0.0 if wd is None else float(wd)
        return self._decay_value(group, p)
