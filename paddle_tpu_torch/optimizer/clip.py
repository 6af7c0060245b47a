"""Gradient clipping (counterpart of ``paddle_tpu/optimizer/clip.py``):
``ClipGradByValue``, ``ClipGradByNorm``, ``ClipGradByGlobalNorm`` and
``clip_grad_norm_``.

An optimizer does not call a clip object on its own: its step folds the
clip into the update kernels (``kernels/fused_adam.py`` ``Prologue``), in
the JAX step's order (``trainer.py:436-460``), with the norms from
``mt_sumsq``. Called directly, a clip returns new gradients as the JAX
clips do: ``clip(params_grads)`` takes ``(param, grad)`` pairs and skips a
parameter whose ``need_clip`` attribute is False; ``clip.clip(grads)``
takes the gradients alone (None entries kept). The norms come from
``mt_sumsq`` on the card (the plain sum on the CPU); the scaling is one
elementwise product in the gradient's type, as in JAX: the global norm in
fp32 (``min(1, clip_norm / max(norm, 1e-12))``, cast back), the per-tensor
norm and its scale in the gradient's own type (``clip.py:44-47``), the
value clip at bounds rounded to that type.
"""
from __future__ import annotations

import torch

from ..kernels import fused_adam as fa


def _selected(params_grads):
    """Indices of the pairs the clip acts on."""
    return [i for i, (p, g) in enumerate(params_grads)
            if g is not None and getattr(p, "need_clip", True)]


class ClipGradBase:
    kind = fa.CLIP_NONE

    def __call__(self, params_grads):
        raise NotImplementedError

    def clip(self, grads):
        """``grads`` (None entries kept) clipped as :meth:`__call__` clips
        them."""
        return [g for _, g in self([(None, g) for g in grads])]

    def prologue(self, inv=None, stats=None, skip=False):
        """The update kernels' prologue that applies this clip."""
        return fa.Prologue(inv, self.kind, stats, skip=skip)


class ClipGradByValue(ClipGradBase):
    """``clamp(g, min, max)``; ``min`` defaults to ``-max``."""

    kind = fa.CLIP_VALUE

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def __call__(self, params_grads):
        out = list(params_grads)
        for i in _selected(out):
            p, g = out[i]
            out[i] = (p, torch.clamp(g, fa.in_type(self.min, g.dtype),
                                     fa.in_type(self.max, g.dtype)))
        return out

    def prologue(self, inv=None, stats=None, skip=False):
        return fa.Prologue(inv, self.kind, stats, lo=self.min, hi=self.max,
                           skip=skip)


class ClipGradByNorm(ClipGradBase):
    """Each gradient scaled by ``clip_norm / max(norm, 1e-12)`` where its
    own norm is above ``clip_norm``, in the gradient's type."""

    kind = fa.CLIP_NORM

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        out = list(params_grads)
        idx = _selected(out)
        if not idx:
            return out
        stats = fa.grad_sumsq([out[i][1] for i in idx])
        for s, i in enumerate(idx):
            p, g = out[i]
            dt = g.dtype
            n = torch.sqrt(stats.sq[s]).to(dt).float()
            c = torch.full_like(n, fa.in_type(self.clip_norm, dt))
            d = torch.div(c, torch.clamp(n, min=fa.in_type(1e-12, dt)))
            scale = torch.where(n > c, d.to(dt).float(), torch.ones_like(n))
            out[i] = (p, (g.float() * scale).to(dt))
        return out

    def prologue(self, inv=None, stats=None, skip=False):
        return fa.Prologue(inv, self.kind, stats, clip_norm=self.clip_norm,
                           skip=skip)


class ClipGradByGlobalNorm(ClipGradBase):
    """Every gradient scaled by ``min(1, clip_norm / max(global norm,
    1e-12))`` in fp32 and cast back; the global norm in fp32 over every
    gradient the clip acts on."""

    kind = fa.CLIP_GLOBAL

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def __call__(self, params_grads):
        out = list(params_grads)
        idx = _selected(out)
        if not idx:
            return out
        stats = fa.grad_sumsq([out[i][1] for i in idx],
                              clip_norm=self.clip_norm)
        for i in idx:
            p, g = out[i]
            out[i] = (p, (g.float() * stats.coef).to(g.dtype))
        return out


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale every parameter's gradient, in place of ``p.grad``, by
    ``min(1, max_norm / max(total norm, 1e-12))`` (fp32, cast back); returns
    the total norm. ``norm_type`` and ``error_if_nonfinite`` are taken and
    not used, as in the JAX package."""
    params = [p for p in parameters if p.grad is not None]
    if not params:
        return torch.zeros(())
    stats = fa.grad_sumsq([p.grad for p in params], clip_norm=max_norm)
    for p in params:
        p.grad = (p.grad.float() * stats.coef).to(p.grad.dtype)
    return torch.sqrt(stats.total)
