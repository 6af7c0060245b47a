"""The tail optimizers: NAdam, RAdam, ASGD, Rprop and LBFGS (counterpart of
``paddle_tpu/optimizer/extra.py``).

Eager only, as in the JAX package (``jit.CompiledTrainStep`` refuses them):
each update is plain PyTorch in the JAX rule's op order, fp32 master math
cast back once to the parameter's type (``optimizer.EagerOptimizer``).
Scalar state (NAdam's step and momentum product, RAdam's step) lives in
0-dim fp32 accumulators, so ``state_dict()`` carries it under JAX's keys.
LBFGS keeps JAX's closure API, flat fp32 views over the parameter list, its
history of ``(s, y)`` pairs and, under ``line_search_fn="strong_wolfe"``,
JAX's Armijo backtracking (the reference's documented simplification,
``extra.py:225-231``), not ``torch.optim.LBFGS``.
"""
from __future__ import annotations

import math

import torch

from .optimizer import _F32, EagerOptimizer, _div, _f32


def _scalar_acc(value):
    return lambda self, p: torch.full((), value, dtype=torch.float32,
                                      device=p.device)


class NAdam(EagerOptimizer):
    """Adam with Nesterov momentum (Dozat 2016 schedule;
    ``_nadam_update``, ``extra.py:19-33``)."""

    _acc_names = ("nadam_t", "nadam_mu_prod", "moment1", "moment2")
    _acc_init = {"nadam_t": _scalar_acc(0.0),
                 "nadam_mu_prod": _scalar_acc(1.0)}

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, momentum_decay=0.004, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._b1, self._b2, self._eps = beta1, beta2, epsilon
        self._psi = momentum_decay

    def _update_param(self, p, g, lr, group):
        g32 = self._decayed(group, p, g).float()
        # the scalar state is read back as JAX reads it (float of fp32)
        t = float(self._acc(p, "nadam_t")) + 1
        self._acc(p, "nadam_t").fill_(_f32(t))
        mu_t = self._b1 * (1 - 0.5 * 0.96 ** (t * self._psi))
        mu_next = self._b1 * (1 - 0.5 * 0.96 ** ((t + 1) * self._psi))
        mu_prod = float(self._acc(p, "nadam_mu_prod")) * mu_t
        self._acc(p, "nadam_mu_prod").fill_(_f32(mu_prod))
        b1, b2 = _F32(self._b1), _F32(self._b2)
        m = self._acc(p, "moment1")
        v = self._acc(p, "moment2")
        m2 = float(b1) * m + float(_F32(1) - b1) * g32
        v2 = float(b2) * v + float(_F32(1) - b2) * (g32 * g32)
        m_hat = (_div(_f32(mu_next) * m2, _F32(1) - _F32(mu_prod * mu_next))
                 + _div(float(_F32(1) - _F32(mu_t)) * g32,
                        _F32(1) - _F32(mu_prod)))
        v_hat = _div(v2, _F32(1 - self._b2 ** t))
        step = (_f32(lr) * m_hat) / (torch.sqrt(v_hat) + _f32(self._eps))
        p.copy_(p.float() - step)
        self._set_acc(p, "moment1", m2)
        self._set_acc(p, "moment2", v2)


class RAdam(EagerOptimizer):
    """Rectified Adam (Liu et al. 2020; ``_radam_update``,
    ``extra.py:83-95``): the variance-rectified step once rho_t > 5,
    else the un-adapted momentum step."""

    _acc_names = ("radam_t", "moment1", "moment2")
    _acc_init = {"radam_t": _scalar_acc(0.0)}

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._b1, self._b2, self._eps = beta1, beta2, epsilon
        self._rho_inf = 2.0 / (1.0 - beta2) - 1.0

    def _update_param(self, p, g, lr, group):
        g32 = self._decayed(group, p, g).float()
        t = float(self._acc(p, "radam_t")) + 1
        self._acc(p, "radam_t").fill_(_f32(t))
        rho_t = (self._rho_inf
                 - 2.0 * t * self._b2 ** t / (1.0 - self._b2 ** t))
        rectified = rho_t > 5.0
        b1, b2 = _F32(self._b1), _F32(self._b2)
        m = self._acc(p, "moment1")
        v = self._acc(p, "moment2")
        m2 = float(b1) * m + float(_F32(1) - b1) * g32
        v2 = float(b2) * v + float(_F32(1) - b2) * (g32 * g32)
        m_hat = _div(m2, _F32(1 - self._b1 ** t))
        if rectified:
            r_t = math.sqrt(
                ((rho_t - 4) * (rho_t - 2) * self._rho_inf)
                / ((self._rho_inf - 4) * (self._rho_inf - 2) * rho_t))
            step = (float(_F32(lr) * _F32(r_t)) * m_hat) / (
                torch.sqrt(_div(v2, _F32(1 - self._b2 ** t)))
                + _f32(self._eps))
        else:  # variance not tractable yet: un-adapted momentum step
            step = _f32(lr) * m_hat
        p.copy_(p.float() - step)
        self._set_acc(p, "moment1", m2)
        self._set_acc(p, "moment2", v2)


class ASGD(EagerOptimizer):
    """Averaged SGD (``_asgd_update``, ``extra.py:131-136``): SGD steps
    plus a running Polyak average of the parameters (``averaged``, fp32,
    started from the parameter before its first step), weighted ``1 /
    max(1, t - t0)``; :meth:`averaged_params` exposes it."""

    _acc_names = ("averaged",)
    _acc_init = {"averaged": lambda self, p: p.detach().float().clone(
        memory_format=torch.contiguous_format)}

    def __init__(self, learning_rate=0.001, t0=1e6, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._t0 = t0
        self._t = 0

    def step(self):
        self._t += 1
        super().step()

    def _update_param(self, p, g, lr, group):
        g32 = self._decayed(group, p, g).float()
        ax = self._acc(p, "averaged")
        mu = 1.0 / max(1.0, self._t - self._t0)
        p2 = p.float() - _f32(lr) * g32
        ax2 = ax + _f32(mu) * (p2 - ax)
        p.copy_(p2)
        self._set_acc(p, "averaged", ax2)

    def averaged_params(self):
        """``{id(parameter): its fp32 running average}``."""
        return {id(p): self._accumulators[(self._names[id(p)], "averaged")]
                for _, p in self._all_params()}


class Rprop(EagerOptimizer):
    """Resilient backprop (``_rprop_update``, ``extra.py:162-170``):
    per-weight step sizes grown by ``etas[1]`` where the gradient keeps its
    sign and shrunk by ``etas[0]`` where it flips (that update skipped),
    clipped to ``learning_rate_range``."""

    _acc_names = ("step_size", "prev_grad")
    _acc_init = {"step_size": lambda self, p: torch.full_like(
        p, self._init_step, dtype=torch.float32,
        memory_format=torch.contiguous_format)}

    def __init__(self, learning_rate=0.001,
                 learning_rate_range=(1e-5, 50.0), parameters=None,
                 etas=(0.5, 1.2), grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._lo, self._hi = learning_rate_range
        self._eta_neg, self._eta_pos = etas
        self._init_step = learning_rate

    def _update_param(self, p, g, lr, group):
        g32 = g.float()
        step = self._acc(p, "step_size")
        prev = self._acc(p, "prev_grad")
        sign = torch.sign(g32 * prev)
        one = torch.ones_like(sign)
        factor = torch.where(sign > 0, _f32(self._eta_pos) * one,
                             torch.where(sign < 0, _f32(self._eta_neg) * one,
                                         one))
        step2 = torch.clamp(step * factor, _f32(self._lo), _f32(self._hi))
        g_eff = torch.where(sign < 0, torch.zeros_like(g32), g32)
        p.copy_(p.float() - torch.sign(g_eff) * step2)
        self._set_acc(p, "step_size", step2)
        self._set_acc(p, "prev_grad", g_eff)


class LBFGS(EagerOptimizer):
    """Limited-memory BFGS with closure re-evaluation (``extra.py:
    209-357``): the two-loop recursion over the last ``history_size``
    ``(s, y)`` pairs of flat fp32 vectors, a fixed step of the learning
    rate, or Armijo backtracking under ``line_search_fn="strong_wolfe"``.
    ``step(closure)``: ``closure()`` computes the loss and its gradients
    (``loss.backward()``) and returns the loss. The history holds
    ``2 x history_size`` fp32 copies of the parameter vector."""

    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-7, tolerance_change=1e-9,
                 history_size=100, line_search_fn=None, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._max_iter = int(max_iter)
        self._max_eval = None if max_eval is None else int(max_eval)
        self._tol_grad = tolerance_grad
        self._tol_change = tolerance_change
        self._hist = int(history_size)
        self._line_search = line_search_fn
        self._s, self._y = [], []

    # -- flat views over the whole parameter list ------------------------
    def _params(self):
        return [p for _, p in self._all_params()]

    @staticmethod
    def _flat(arrs):
        return torch.cat([a.detach().reshape(-1).float() for a in arrs])

    @torch.no_grad()
    def _assign_flat(self, flat):
        off = 0
        for p in self._params():
            n = p.numel()
            p.copy_(flat[off:off + n].reshape(p.shape))
            off += n

    def _grads(self):
        """The flat fp32 gradient, clipped and with L2 decay (missing
        gradients as zeros)."""
        pairs = [(p, torch.zeros_like(p) if p.grad is None else p.grad,
                  group) for group, p in self._all_params()]
        if self._grad_clip is not None:
            clipped = self._grad_clip([(p, g) for p, g, _ in pairs])
            pairs = [(p, g, grp)
                     for (p, g), (_, _, grp) in zip(clipped, pairs)]
        flats = []
        for p, g, group in pairs:
            gv = g.float()
            wd, l1 = self._decay_value(group, p)
            if wd and not l1:
                gv = gv + wd * p.detach().float()
            flats.append(gv.reshape(-1))
        return torch.cat(flats)

    def _direction(self, g):
        q = g
        alphas = []
        for s, y in zip(reversed(self._s), reversed(self._y)):
            rho = 1.0 / torch.clamp(torch.dot(y, s), min=1e-10)
            a = rho * torch.dot(s, q)
            q = q - a * y
            alphas.append((rho, a, s, y))
        if self._y:
            y_last, s_last = self._y[-1], self._s[-1]
            gamma = torch.dot(s_last, y_last) / torch.clamp(
                torch.dot(y_last, y_last), min=1e-10)
            q = q * gamma
        for rho, a, s, y in reversed(alphas):
            b = rho * torch.dot(y, q)
            q = q + (a - b) * s
        return -q

    def step(self, closure=None):
        if closure is None:
            raise ValueError("LBFGS.step requires a closure")
        self.clear_grad()  # stale gradients would accumulate
        self._evals = 0
        loss = closure()
        self._evals += 1
        for _ in range(self._max_iter):
            if self._max_eval is not None and self._evals >= self._max_eval:
                break
            g = self._grads()
            if float(g.abs().max()) <= self._tol_grad:
                break
            d = self._direction(g)
            x0 = self._flat(self._params())
            lr = float(self.get_lr())
            if self._line_search == "strong_wolfe":
                f0 = float(loss.detach())
                gtd = float(torch.dot(g, d))
                t = lr
                for _ls in range(20):  # Armijo backtracking
                    self._assign_flat(x0 + t * d)
                    self.clear_grad()
                    loss = closure()
                    self._evals += 1
                    if float(loss.detach()) <= f0 + 1e-4 * t * gtd:
                        break
                    if (self._max_eval is not None
                            and self._evals >= self._max_eval):
                        break
                    t *= 0.5
            else:
                self._assign_flat(x0 + lr * d)
                self.clear_grad()
                loss = closure()
                self._evals += 1
            g_new = self._grads()
            s = self._flat(self._params()) - x0
            y = g_new - g
            if float(torch.dot(s, y)) > 1e-10:
                self._s.append(s)
                self._y.append(y)
                if len(self._s) > self._hist:
                    self._s.pop(0)
                    self._y.pop(0)
            if float(s.abs().max()) <= self._tol_change:
                break
        return loss
