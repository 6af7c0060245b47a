"""Optimizers: ``Optimizer``, ``SGD``, ``Momentum``, ``Adam``, ``AdamW`` and
``Lamb`` (counterpart of ``paddle_tpu/optimizer/optimizer.py``, ``:129``,
``:336``, ``:350``, ``:372``, ``:459`` and ``:488``).

Every update runs through the multi-tensor functions of
``kernels/fused_adam.py`` (the hand-written kernels of
``csrc/multi_tensor.cu`` on a CUDA tensor, their plain versions on a CPU
one) in the JAX update rules' fp32 op order (``_sgd_update``,
``_momentum_update``, ``_adam_update``, ``_lamb_update``,
``optimizer.py:28-72``): decoupled decay multiplies the fp32 parameter by
``1 - lr * weight_decay`` before the step is taken, the Adam step is ``lr
* mhat / (sqrt(vhat) + eps)`` with the bias corrections ``1 - beta ** t``
at a float step count ``t``, and the result is cast back once. (``torch.
optim.AdamW`` computes ``lr / bc1 * m / (sqrt(v) / sqrt(bc2) + eps)`` and
drifts from it at fp32.) The scalars are rounded to fp32 on the host before
they meet a tensor, as the JAX step's fp32 scalars are. Moments are fp32
tensors on the parameter's device, made before the first update and
updated in place.

The gradient clip is folded into the update (``fused_adam.Prologue``: the
global and per-tensor norms from one ``mt_sumsq`` pass), and so is the
decay: ``L2Decay`` or a float adds ``wd * p`` to the gradient (AdamW:
decays the parameter), ``L1Decay`` adds ``coeff * sign(p)`` (JAX's
``_apply_l1``, here in the kernels' prologue); a parameter's
``regularizer`` attribute comes before its group's ``weight_decay``, which
comes before the optimizer's (``_decay_value``, ``optimizer.py:212-226``).
A parameter whose ``need_clip`` is False is not clipped; one with
``requires_grad=False`` (or no gradient) is skipped, as JAX skips
``stop_gradient``.

The eager :meth:`Optimizer.step` updates each parameter with a call on a
list of one, as the JAX optimizers update each parameter with one jitted
call; ``Adam(use_multi_tensor=True)`` buckets the parameters by ``(lr x
multiplier, weight decay)`` and makes one call a bucket
(``optimizer.py:385-436``; an L1 parameter alone). The compiled train step
(``jit/trainer.py``) makes one call a bucket for every optimizer.

``parameters`` is a list of tensors, of ``(name, tensor)`` pairs (what
``net.named_parameters()`` yields), or of group dicts ``{"params": [...],
"learning_rate": multiplier, "weight_decay": coeff or regularizer}``. A
parameter's name (``param_<i>`` when none is given) keys its state and is
what ``apply_decay_param_fun`` receives; a tensor's ``optimize_attr``
dict's ``learning_rate`` multiplies its rate, as a Paddle parameter's does.
"""
from __future__ import annotations

import numbers

import numpy as np
import torch

from ..kernels import fused_adam as fa
from .clip import ClipGradBase
from .lr import LRScheduler
from .regularizer import L1Decay, L2Decay, WeightDecayRegularizer

_F32 = np.float32


class Optimizer:
    # the eager step makes one update call a bucket (Adam's
    # use_multi_tensor); else one a parameter
    _use_multi_tensor = False
    # the accumulators the update keeps for each parameter
    _acc_names = ()

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
        if weight_decay is not None and not isinstance(
                weight_decay, (numbers.Real, WeightDecayRegularizer)):
            raise TypeError(f"{op}: weight_decay expected a float, L1Decay "
                            f"or L2Decay, got {type(weight_decay).__name__}")
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

    @staticmethod
    def lr_multiplier(group, p=None):
        """A group's ``learning_rate`` times the parameter's own
        (``optimize_attr``): multipliers of the scheduled rate."""
        own = getattr(p, "optimize_attr", None) or {}
        return (float(group.get("learning_rate", 1.0))
                * float(own.get("learning_rate", 1.0)))

    # --------------------------------------------------------------- decay
    _OWN = object()

    def _decay_value(self, group, p=None, default=_OWN):
        """``(coeff, l1)`` of ``p``: its ``regularizer``, else its group's
        ``weight_decay``, else ``default`` (the optimizer's own unless
        given); ``l1`` is ``"l1"`` for an ``L1Decay``, else False (``(0.0,
        False)`` when none is set)."""
        if default is self._OWN:
            default = self._weight_decay
        wd = getattr(p, "regularizer", None) if p is not None else None
        if wd is None:
            wd = group.get("weight_decay", default)
        if wd is None:
            return 0.0, False
        if isinstance(wd, L2Decay):
            return float(wd.coeff), False
        if isinstance(wd, L1Decay):
            return float(wd.coeff), "l1"
        return float(wd), False

    def _eager_decay(self, group, p):
        """``(L2 coefficient, L1 coefficient)`` of ``p`` in the eager
        step."""
        coeff, l1 = self._decay_value(group, p)
        return (0.0, coeff) if l1 else (coeff, 0.0)

    def _in_step_decay(self, group, p):
        """``(coeff, l1)`` of ``p`` in the compiled train step
        (``trainer.py:284-300``)."""
        return self._decay_value(group, p)

    # -------------------------------------------------------------- update
    def _params_grads(self):
        return [(p, p.grad, g) for g, p in self._all_params()
                if p.grad is not None and p.requires_grad]

    def step(self):
        """The eager step: parameters without a gradient are skipped; the
        clip, the decay and the update of each parameter."""
        items = self._params_grads()
        if not items:
            return
        self._step_count += 1
        self._apply(items, self.get_lr())

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        return None, [(p, p.grad) for _, p in self._all_params()]

    @torch.no_grad()
    def _apply(self, items, lr, plan=None, inv=None):
        """Clip, decay and update ``items``, ``(param, grad, group)``
        triples, at the scheduled rate ``lr``. Eager when ``plan`` is None
        (the clip honours ``need_clip``; one call a parameter unless
        ``_use_multi_tensor``); else the compiled step's: ``plan[id(p)]`` is
        ``(wd, lr multiplier)``, every gradient is clipped, one call a
        bucket, and ``inv`` (an fp32 device scalar) unscales every
        gradient, whose non-finite values then skip the whole update.
        Returns the ``mt_sumsq`` stats (None when no norm was needed)."""
        clip = self._grad_clip
        in_step = plan is not None
        if clip is not None and (not isinstance(clip, ClipGradBase)
                                 or clip.kind == fa.CLIP_NONE):
            raise TypeError(f"grad_clip expected ClipGradByValue, "
                            f"ClipGradByNorm or ClipGradByGlobalNorm, got "
                            f"{type(clip).__name__}")
        on = [clip is not None and (in_step or getattr(p, "need_clip", True))
              for p, _, _ in items]
        kind = fa.CLIP_NONE if clip is None else clip.kind
        stats, slots = None, [0] * len(items)
        if inv is not None or kind in (fa.CLIP_GLOBAL, fa.CLIP_NORM):
            idx = [i for i in range(len(items)) if inv is not None or on[i]]
            if idx:
                stats = fa.grad_sumsq(
                    [items[i][1] for i in idx], inv=inv,
                    clip_norm=clip.clip_norm if kind == fa.CLIP_GLOBAL
                    else 0.0,
                    skip_nonfinite=inv is not None)
            for s, i in enumerate(idx):
                slots[i] = s
        skip = inv is not None
        pro_on = clip.prologue(inv, stats, skip) if any(on) else None
        pro_off = fa.Prologue(inv, fa.CLIP_NONE, stats, skip=skip)
        buckets = {}
        for i, (p, g, group) in enumerate(items):
            if in_step:
                wd, mult = plan[id(p)]
                l1 = 0.0
                plr = float(_F32(lr) * _F32(mult))
            else:
                wd, l1 = self._eager_decay(group, p)
                plr = lr * self.lr_multiplier(group, p)
            pro = pro_on if on[i] else pro_off
            key = ((plr, wd, l1, id(pro)) if in_step or (
                self._use_multi_tensor and not l1) else i)
            bucket = buckets.setdefault(key, (plr, wd, l1, pro, []))
            bucket[4].append((p, g, slots[i]))
        for plr, wd, l1, pro, rows in buckets.values():
            self._update(rows, plr, wd, l1, pro)
        return stats

    def _update(self, rows, lr, wd, l1, prologue):
        """One update call over ``rows``, ``(param, grad, slot)``."""
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

    def _state_names(self):
        """``{state key name: parameter}``: JAX's ``p.name or
        f"param_{i}"`` (``paddle_tpu/optimizer/optimizer.py:302-314``),
        ``i`` the parameter's index across the groups. A torch tensor
        has no ``name`` unless the caller set one, so the keys are the
        reference's for the same model, whatever name a ``(name,
        tensor)`` pair gave (that name stays what
        ``apply_decay_param_fun`` receives)."""
        return {getattr(p, "name", None) or f"param_{i}": p
                for i, (_, p) in enumerate(self._all_params())}

    def state_dict(self):
        """Every accumulator under ``<state name>__<accumulator>`` (those
        a step has not created yet as zeros, as the first step would
        create them, so that a restore into a fresh optimizer fills every
        one in place), ``@step_count`` and the LR scheduler's state."""
        sd = {}
        for pname, p in self._state_names().items():
            for acc in self._acc_names:
                sd[f"{pname}__{acc}"] = self._acc(p, acc)
        sd["@step_count"] = self._step_count
        if isinstance(self._lr, LRScheduler):
            sd["LR_Scheduler"] = self._lr.state_dict()
        return sd

    def set_state_dict(self, state):
        """Load :meth:`state_dict`'s keys: into the existing accumulator
        in place where there is one, so tensors the optimizer hands out
        stay valid."""
        by_name = self._state_names()
        self._step_count = int(state.get("@step_count", 0))
        if "LR_Scheduler" in state and isinstance(self._lr, LRScheduler):
            self._lr.set_state_dict(state["LR_Scheduler"])
        for k, v in state.items():
            if k in ("@step_count", "LR_Scheduler") or "__" not in k:
                continue
            pname, acc = k.rsplit("__", 1)
            p = by_name.get(pname)
            if p is None:
                continue
            key = (self._names[id(p)], acc)
            src = torch.as_tensor(
                np.asarray(v) if not isinstance(v, torch.Tensor) else v)
            cur = self._accumulators.get(key)
            if cur is not None and tuple(cur.shape) == tuple(src.shape):
                if src is not cur:
                    with torch.no_grad():
                        cur.copy_(src)
            else:
                self._accumulators[key] = src.to(
                    dtype=torch.float32, device=p.device).clone()

    set_dict = set_state_dict


def _columns(rows):
    ps = [p for p, _, _ in rows]
    gs = [g for _, g, _ in rows]
    return ps, gs, [s for _, _, s in rows]


class SGD(Optimizer):
    """``p - lr * g`` (``_sgd_update``); ``multi_precision`` is taken and
    not used, as in the JAX package."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)

    def _update(self, rows, lr, wd, l1, prologue):
        ps, gs, slots = _columns(rows)
        fa.momentum_update(ps, None, gs, lr, weight_decay=wd, l1=l1,
                           prologue=prologue, slots=slots)


class Momentum(Optimizer):
    """``v = mu * v + g``; ``p - lr * (g + mu * v)`` with Nesterov, else
    ``p - lr * v`` (``_momentum_update``)."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._momentum = momentum
        self._nesterov = use_nesterov

    _acc_names = ("velocity",)

    def _update(self, rows, lr, wd, l1, prologue):
        ps, gs, slots = _columns(rows)
        vel = [self._acc(p, "velocity") for p in ps]
        fa.momentum_update(ps, vel, gs, lr, self._momentum, self._nesterov,
                           weight_decay=wd, l1=l1, prologue=prologue,
                           slots=slots)


class Adam(Optimizer):
    """Adam (``_adam_update``, coupled decay: ``g + wd * p`` in fp32).
    ``lazy_mode`` and ``multi_precision`` are taken and not used, as in the
    JAX package; ``use_multi_tensor`` buckets the eager update."""

    _decoupled = False
    _acc_names = ("moment1", "moment2")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1 = beta1
        self._beta2 = beta2
        self._eps = epsilon
        self._use_multi_tensor = bool(use_multi_tensor)

    def decay_of(self, group, p):
        """The weight decay ``p`` gets under this optimizer."""
        return self._in_step_decay(group, p)[0]

    def _update(self, rows, lr, wd, l1, prologue):
        ps, gs, slots = _columns(rows)
        ms = [self._acc(p, "moment1") for p in ps]
        vs = [self._acc(p, "moment2") for p in ps]
        fa.fused_adam_update(ps, ms, vs, gs, lr, self._beta1, self._beta2,
                             self._eps, self._step_count, self._decoupled,
                             wd, l1=l1, prologue=prologue, slots=slots)


class AdamW(Adam):
    """Decoupled weight decay (paddle.optimizer.AdamW).
    ``apply_decay_param_fun(name)`` returning False exempts a parameter
    from the optimizer-level decay (a group-level or per-parameter one
    still applies, as in the JAX eager step and trainer; the JAX
    multi-tensor path drops every decay of such a parameter, and so does
    ``use_multi_tensor=True`` here). ``lr_ratio`` is taken and not used, as
    in the JAX package."""

    _decoupled = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision,
                         use_multi_tensor, name=name)
        self._apply_decay_fun = apply_decay_param_fun

    def _exempt(self, p):
        return (self._apply_decay_fun is not None
                and not self._apply_decay_fun(self.param_name(p)))

    def _in_step_decay(self, group, p):
        if self._exempt(p):
            return self._decay_value(group, p, default=None)
        return self._decay_value(group, p)

    def _eager_decay(self, group, p):
        coeff, l1 = self._in_step_decay(group, p)
        if l1:
            return 0.0, coeff
        if self._use_multi_tensor and self._exempt(p):
            return 0.0, 0.0
        return coeff, 0.0


class Lamb(Optimizer):
    """Lamb (``_lamb_update``): Adam's moments, ``r = mhat / (sqrt(vhat) +
    eps) + lamb_weight_decay * p``, ``p - lr * (|p| / |r|) * r``.
    ``exclude_from_weight_decay_fn(p)`` returning True gives ``p`` no decay
    in the eager step; the compiled train step gives every parameter
    ``lamb_weight_decay``, as the JAX trainer does (``trainer.py:495``)."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-06, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._lamb_wd = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    _acc_names = ("moment1", "moment2")

    def _eager_decay(self, group, p):
        if self._exclude_fn is not None and self._exclude_fn(p):
            return 0.0, 0.0
        return float(self._lamb_wd), 0.0

    def _in_step_decay(self, group, p):
        _, l1 = self._decay_value(group, p)
        return float(self._lamb_wd), l1

    def _update(self, rows, lr, wd, l1, prologue):
        ps, gs, slots = _columns(rows)
        ms = [self._acc(p, "moment1") for p in ps]
        vs = [self._acc(p, "moment2") for p in ps]
        fa.lamb_update(ps, ms, vs, gs, lr, self._beta1, self._beta2,
                       self._eps, self._step_count, wd, prologue=prologue,
                       slots=slots)


# ------------------------------------------------- the eager-only optimizers
def _f32(x):
    """The Python scalar ``x`` as JAX's ``jnp.float32(x)`` (a Python
    float of fp32 value: it meets an fp32 tensor unchanged)."""
    return float(_F32(x))


class EagerOptimizer(Optimizer):
    """The optimizers the JAX package runs only eagerly (``CompiledTrainStep``
    refuses them): its base ``step()`` (``optimizer.py:229-254``) clips
    the gradients with the clip object, then updates each parameter with
    one update rule at ``lr x multiplier``. The rules are plain PyTorch,
    as JAX's are plain jitted XLA outside any Pallas kernel: each in JAX's
    op order, in fp32 (the parameter and gradient upcast), cast back once
    to the parameter's type, its accumulators fp32 under JAX's names. The
    scalars are rounded to fp32 first, as ``jnp.float32(...)`` does; a
    scalar divisor is a 0-dim fp32 tensor, so that the card divides
    instead of multiplying by a reciprocal."""

    # accumulator name -> its initial value (a float, or a callable of the
    # parameter); unlisted ones start at zeros, as JAX's ``_acc``
    _acc_init = {}

    def step(self):
        items = self._params_grads()
        if not items:
            return
        if self._grad_clip is not None:
            clipped = self._grad_clip([(p, g) for p, g, _ in items])
            items = [(p, g, grp)
                     for (p, g), (_, _, grp) in zip(clipped, items)]
        self._step_count += 1
        lr = self.get_lr()
        with torch.no_grad():
            for p, g, group in items:
                self._update_param(p, g, lr * self.lr_multiplier(group, p),
                                   group)

    def _update_param(self, p, g, lr, group):
        raise NotImplementedError

    def _decayed(self, group, p, g):
        """``g`` with ``p``'s decay added as JAX's eager step adds it:
        ``g + coeff * sign(p)`` (L1), ``g + wd * p`` (L2), in g's type."""
        wd, l1 = self._decay_value(group, p)
        if l1:
            return g + wd * torch.sign(p)
        return g + wd * p if wd else g

    def _acc(self, p, name):
        key = (self._names[id(p)], name)
        if key not in self._accumulators:
            init = self._acc_init.get(name)
            if callable(init):
                v = init(self, p)
            else:
                v = torch.zeros_like(p, dtype=torch.float32,
                                     memory_format=torch.contiguous_format)
                if init:
                    v.fill_(init)
            self._accumulators[key] = v
        return self._accumulators[key]

    def _set_acc(self, p, name, value):
        self._accumulators[(self._names[id(p)], name)] = value


def _div(x, d):
    """``x / d`` for a Python scalar ``d``, divided (not multiplied by a
    reciprocal) on every device."""
    return x / fa._scalar(d, x)


class Adagrad(EagerOptimizer):
    """``acc += g^2``; ``p - lr * g / (sqrt(acc) + eps)``
    (``_adagrad_update``, ``optimizer.py:75-79``)."""

    _acc_names = ("moment",)
    _acc_init = {"moment": lambda self, p: torch.full_like(
        p, self._init_acc, dtype=torch.float32,
        memory_format=torch.contiguous_format)}

    def __init__(self, learning_rate, epsilon=1e-06, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._eps = epsilon
        self._init_acc = initial_accumulator_value

    def _update_param(self, p, g, lr, group):
        g32 = self._decayed(group, p, g).float()
        acc2 = self._acc(p, "moment") + g32 * g32
        upd = (_f32(lr) * g32) / (torch.sqrt(acc2) + _f32(self._eps))
        p.copy_(p.float() - upd)
        self._set_acc(p, "moment", acc2)


class RMSProp(EagerOptimizer):
    """``ms = rho ms + (1 - rho) g^2``, centered ``mg = rho mg + (1 -
    rho) g`` and ``sqrt(ms - mg^2 + eps)``, else ``sqrt(ms + eps)``;
    ``mom = momentum mom + lr g / denom``; ``p - mom``
    (``_rmsprop_update``, ``optimizer.py:113-127``)."""

    _acc_names = ("mean_square", "momentum", "mean_grad")

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-06, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho, self._eps = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _update_param(self, p, g, lr, group):
        g32 = self._decayed(group, p, g).float()
        rho, omr = _f32(self._rho), float(_F32(1) - _F32(self._rho))
        ms = self._acc(p, "mean_square")
        mom = self._acc(p, "momentum")
        mg = self._acc(p, "mean_grad")
        ms2 = rho * ms + omr * (g32 * g32)
        if self._centered:
            mg2 = rho * mg + omr * g32
            denom = torch.sqrt(ms2 - mg2 * mg2 + _f32(self._eps))
        else:
            mg2 = mg
            denom = torch.sqrt(ms2 + _f32(self._eps))
        mom2 = _f32(self._momentum) * mom + (_f32(lr) * g32) / denom
        p.copy_(p.float() - mom2)
        self._set_acc(p, "mean_square", ms2)
        self._set_acc(p, "momentum", mom2)
        self._set_acc(p, "mean_grad", mg2)


class Adadelta(EagerOptimizer):
    """``avg_sq = rho avg_sq + (1 - rho) g^2``; ``upd = sqrt(avg_upd +
    eps) / sqrt(avg_sq + eps) g``; ``avg_upd = rho avg_upd + (1 - rho)
    upd^2``; ``p - lr upd`` (``_adadelta_update``, ``optimizer.py:87-96``)."""

    _acc_names = ("avg_squared_grad", "avg_squared_update")

    def __init__(self, learning_rate=0.001, epsilon=1e-06, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._eps, self._rho = epsilon, rho

    def _update_param(self, p, g, lr, group):
        g32 = self._decayed(group, p, g).float()
        rho, omr = _f32(self._rho), float(_F32(1) - _F32(self._rho))
        eps = _f32(self._eps)
        avg_sq = self._acc(p, "avg_squared_grad")
        avg_upd = self._acc(p, "avg_squared_update")
        avg_sq2 = rho * avg_sq + omr * (g32 * g32)
        upd = torch.sqrt(avg_upd + eps) / torch.sqrt(avg_sq2 + eps) * g32
        avg_upd2 = rho * avg_upd + omr * (upd * upd)
        p.copy_(p.float() - _f32(lr) * upd)
        self._set_acc(p, "avg_squared_grad", avg_sq2)
        self._set_acc(p, "avg_squared_update", avg_upd2)


class Adamax(EagerOptimizer):
    """``m = beta1 m + (1 - beta1) g``; ``u = max(beta2 u, |g|)``; ``p -
    lr / (1 - beta1^t) m / (u + eps)`` (``_adamax_update``,
    ``optimizer.py:99-109``)."""

    _acc_names = ("moment", "inf_norm")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def _update_param(self, p, g, lr, group):
        g32 = self._decayed(group, p, g).float()
        b1 = _F32(self._beta1)
        m = self._acc(p, "moment")
        u = self._acc(p, "inf_norm")
        m2 = float(b1) * m + float(_F32(1) - b1) * g32
        u2 = torch.maximum(_f32(self._beta2) * u, g32.abs())
        denom = _F32(1) - np.power(b1, _F32(self._step_count))
        step = float(_F32(lr) / denom) * m2 / (u2 + _f32(self._eps))
        p.copy_(p.float() - step)
        self._set_acc(p, "moment", m2)
        self._set_acc(p, "inf_norm", u2)
