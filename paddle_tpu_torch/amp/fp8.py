"""AMP "O3": fp8 train-step matmuls with per-tensor delayed scaling
(counterpart of ``paddle_tpu/amp/fp8.py``).

One level past O2: every ``F.linear`` of the train step (the q/k/v/o
projections, the SwiGLU products, the lm_head) multiplies **e4m3
operands** in the forward and an **e5m2 gradient** in the backward, with
fp32 sums, while every other op keeps O1's casts. On a card both run
through the hand-written kernels of ``kernels/fp8_matmul.py``
(``csrc/fp8_matmul.cu``: ``fp8_quantize`` for every cast and amax,
``fp8_gemm`` for every product); on the CPU through their plain
versions.

Scaling, as in JAX:

- forward (delayed): each site keeps an amax history per operand
  (``[HISTORY_LEN]`` fp32); step t quantizes with the scale of the
  history of steps < t, so the scale is known before the tensor is made.
  The quantize launch that casts x (or w) also writes this step's amax,
  which enters the history (:func:`_roll_in`) for the next step;
- backward (just in time): the gradient quantizes to e5m2 with a scale
  from its own amax (an amax-only launch over g, then the quantize).

Scales and histories are device tensors end to end: nothing is read
back to the host (the port's ``CompiledTrainStep`` carries the histories
between steps as JAX's carries them through its compiled step).
Call sites route here through :func:`active`: only inside
:func:`fp8_autocast` (the trainer arms it for ``amp_level="O3"``).
"""
from __future__ import annotations

import contextlib
import threading

import torch

E4M3_MAX = 448.0          # max finite float8_e4m3fn
E5M2_MAX = 57344.0        # max finite float8_e5m2
HISTORY_LEN = 16          # amax history window per tensor site
_EPS = 1e-12


class _Fp8State(threading.local):
    def __init__(self):
        self.ctx = None


_TL = _Fp8State()


class Fp8Context:
    """Per-step bookkeeping: serves each matmul site its delayed scale
    (from the carried history) and collects the updated histories, keyed
    by call order (``linear{n}``): the forward is the same every step, so
    site n is the same matmul every step."""

    def __init__(self, state):
        self.state = state or {}
        self.new_state = {}
        self._n = 0
        self.weight_bytes_saved = 0  # analytic, host-side

    def site(self):
        k = f"linear{self._n}"
        self._n += 1
        return k

    def history(self, site, operand, device):
        key = f"{site}/{operand}"
        h = self.state.get(key)
        if h is None:
            h = torch.zeros((HISTORY_LEN,), dtype=torch.float32,
                            device=device)
        return key, h


def active():
    return _TL.ctx is not None


def current():
    return _TL.ctx


@contextlib.contextmanager
def fp8_autocast(state=None):
    """Arm fp8 matmul routing for the enclosed region (the forward and
    the loss). ``state``: the carried ``{site/operand: amax history}``
    of the previous step (None at the first). The context's
    ``new_state`` holds the updated histories to carry forward."""
    prev = _TL.ctx
    ctx = Fp8Context(state)
    _TL.ctx = ctx
    try:
        yield ctx
    finally:
        _TL.ctx = prev


def _delayed_scale(history, fmax):
    """Scale from the amax history (delayed scaling): amax / fmax with a
    margin-free floor; an empty history (all zeros) gives scale 1."""
    amax = torch.amax(history)
    return torch.where(amax > 0, torch.clamp_min(amax, _EPS) / fmax,
                       torch.ones_like(amax))


def _roll_in(history, amax):
    """The newest amax enters at slot 0; the window slides."""
    return torch.cat([amax.reshape(1).float(), history[:-1]])


def _quantize(x, scale, fmt):
    """Scale, saturate into the format's range, cast (round to nearest
    even): the codes of ``x`` (2-D) in ``fmt``, "e4m3" or "e5m2"."""
    from ..kernels import fp8_matmul as _k

    return _k.quantize(x, scale, fmt)[0]


class _Fp8Dot(torch.autograd.Function):
    """``[M, K] @ [K, N]`` with e4m3 operands and fp32 sums, the scales
    applied in the epilogue; returns the product in x's dtype and the
    amaxes of x and w (no gradient), which the quantize launches wrote.

    Saved for the backward: the codes it reads, ``qx^T`` ``[K, M]`` and
    ``qw`` ``[K, N]`` (JAX saves ``qx`` and ``qw``: the same bytes), and
    the two scales. The forward's ``qx`` and ``qw^T`` are freed after
    the product."""

    @staticmethod
    def forward(ctx, x2d, w, sx, sw):
        from ..kernels import fp8_matmul as _k

        need_dx, need_dw = ctx.needs_input_grad[0], ctx.needs_input_grad[1]
        qx, qxt, ax = _k.quantize(x2d, sx, "e4m3", rows=True,
                                  transposed=need_dw, amax=True)
        qw, qwt, aw = _k.quantize(w, sw, "e4m3", rows=need_dx,
                                  transposed=True, amax=True)
        out = _k.gemm(qx, qwt, sx, sw, x2d.dtype)
        ctx.save_for_backward(qxt, qw, sx, sw)
        ctx.dtypes = (x2d.dtype, w.dtype)
        ctx.mark_non_differentiable(ax, aw)
        return out, ax, aw

    @staticmethod
    def backward(ctx, g, _ax, _aw):
        from ..kernels import fp8_matmul as _k

        qxt, qw, sx, sw = ctx.saved_tensors
        x_dtype, w_dtype = ctx.dtypes
        need_dx, need_dw = ctx.needs_input_grad[0], ctx.needs_input_grad[1]
        g = g.contiguous()
        # e5m2 gradient with a just-in-time per-tensor scale
        ga = _k.quantize(g, None, "e5m2", rows=False, amax=True)[2]
        sg = torch.where(ga > 0, torch.clamp_min(ga, _EPS) / E5M2_MAX,
                         torch.ones_like(ga))
        qg, qgt, _ = _k.quantize(g, sg, "e5m2", rows=need_dx,
                                 transposed=need_dw)
        dx = _k.gemm(qg, qw, sg, sw, x_dtype) if need_dx else None
        dw = _k.gemm(qxt, qgt, sx, sg, w_dtype) if need_dw else None
        # the scales came from the histories (no gradient)
        return dx, dw, None, None


def fp8_linear_value(x, w, b):
    """The O3 body of ``F.linear``: e4m3 x and w with delayed scales,
    the product in x's dtype, the bias added outside the fp8 path."""
    ctx = _TL.ctx
    site = ctx.site()
    kx, hx = ctx.history(site, "x", x.device)
    kw, hw = ctx.history(site, "w", x.device)
    sx = _delayed_scale(hx, E4M3_MAX)
    sw = _delayed_scale(hw, E4M3_MAX)
    shape = x.shape
    k = int(shape[-1])
    x2d = x.reshape(-1, k)
    out, ax, aw = _Fp8Dot.apply(x2d, w.contiguous(), sx, sw)
    out = out.reshape(tuple(shape[:-1]) + (int(w.shape[-1]),))
    # this step's amaxes enter the carried histories (read from the next
    # step on: that is what makes the scaling "delayed")
    ctx.new_state[kx] = _roll_in(hx, ax)
    ctx.new_state[kw] = _roll_in(hw, aw)
    # analytic HBM delta: this matmul's weight crosses the bus as fp8
    # (1 byte) instead of its stored width
    ctx.weight_bytes_saved += int(w.numel()) * max(w.element_size() - 1, 0)
    if b is not None:
        out = out + b
    return out
