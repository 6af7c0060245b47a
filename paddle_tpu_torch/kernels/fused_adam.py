"""Multi-tensor optimizer updates and gradient sums of squares: the
hand-written Hopper kernels and their plain versions.

Counterpart of ``paddle_tpu/kernels/fused_adam.py`` ``fused_adam_update``
(one jitted update over a whole parameter pytree) and of the optimizer
layer that XLA fuses inside the JAX train step
(``paddle_tpu/jit/trainer.py:394-500``). Neither is a Pallas kernel: on a
TPU, XLA's fusion is the multi-tensor kernel. The CUDA source is
``paddle_tpu_torch/csrc/multi_tensor.cu``; its header says what bounds the
four families on the H100 and how the design answers that:

- :func:`grad_sumsq` (``mt_sumsq``): the fp32 sum of squares of every
  gradient, the non-finite count, the global-norm clip coefficient and the
  loss scaler's skip flag, in one device buffer (:class:`GradStats`);
- :func:`fused_adam_update` (``mt_adam``): Adam and AdamW in
  ``_adam_update``'s op order (``paddle_tpu/optimizer/optimizer.py:44-56``);
- :func:`momentum_update` (``mt_momentum``): SGD, and Momentum with or
  without Nesterov (``optimizer.py:28-40``);
- :func:`lamb_update` (``mt_lamb``): Lamb (``optimizer.py:60-72``).

Each update first applies a :class:`Prologue`, what the step does to a
gradient before the update, in the JAX step's order: the loss scaler's
unscale, one of the three clips, then the L2 or L1 decay; and writes nothing
when the prologue's skip flag (a non-finite gradient under a loss scaler)
is set. Scalars that change from step to step (the inverse loss scale, the
clip coefficient, the skip flag) stay in device buffers: nothing is read
back. Parameters are fp32, bf16 or fp16, gradients fp32, bf16 or fp16 (a
bf16 parameter takes no fp16 gradient, nor the reverse; rounded to their
own type after each prologue step, as ``.astype(g.dtype)`` does), moments
fp32; all are updated in place.

Every function routes on the device: a CPU tensor runs the plain version
(``*_reference``), a CUDA tensor the kernel, which launches or raises. The
plain versions are written op by op as the kernels compute (every
operation rounded once, divisions by device tensors so that no reciprocal
is taken), so on the card ``mt_adam`` and ``mt_momentum`` equal them bit
for bit; ``mt_sumsq`` and ``mt_lamb`` sum in another order.

Launch counters (``kernels.launch_counts()``): each wrapper adds the
kernels it launched. A call's list is cut into tables of up to 79 tensors
for Adam and Lamb, 95 for momentum and 159 for the sum of squares (the 4
KB of kernel parameters), each dtype pair apart; a table is one launch for
Adam and momentum, three for Lamb (moments, per-tensor sums, apply) and
two for the sum of squares (chunks, per-tensor sums), whose call adds one
finalize launch. A table of empty tensors launches no update.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

# elements of one tensor a CTA owns (csrc/multi_tensor.cu kChunk)
CHUNK = 16384

# kernels launched by this process (see the module docstring)
sumsq_launches = 0
adam_launches = 0
momentum_launches = 0
lamb_launches = 0
# of those, the launches over fp16 tensors (a sum of squares whose list
# holds an fp16 gradient; an update of an fp16 parameter or gradient)
fp16_sumsq_launches = 0
fp16_adam_launches = 0

# clip kinds and decay kinds, shared with csrc/multi_tensor.cu
CLIP_NONE, CLIP_GLOBAL, CLIP_NORM, CLIP_VALUE = 0, 1, 2, 3
DECAY_NONE, DECAY_L2, DECAY_L1 = 0, 1, 2

_F32 = np.float32
_TYPES = (torch.float32, torch.bfloat16, torch.float16)


def _round(x32, dtype):
    """fp32 ``x32`` rounded to ``dtype`` and back (nothing for fp32)."""
    return x32 if dtype == torch.float32 else x32.to(dtype).float()


def in_type(x, dtype):
    """The Python float ``x`` rounded to ``dtype`` (fp32, bf16 or fp16), as a
    Python scalar meets a tensor of that type in the JAX step."""
    return float(torch.tensor(float(x), dtype=torch.float64).to(dtype))


def _scalar(x, like):
    """``x`` as an fp32 tensor on ``like``'s device: dividing by it divides
    (PyTorch multiplies by the reciprocal of a Python scalar divisor on the
    card)."""
    return torch.full((), float(x), dtype=torch.float32, device=like.device)


# ------------------------------------------------------------- the stats
class GradStats:
    """``mt_sumsq``'s result: one fp32 buffer on the gradients' device,
    ``[total, non-finite count, clip coefficient, skip flag, sq[T],
    non-finite[T]]`` for T gradients. ``total`` and ``sq`` are sums of
    squares (of the unscaled values when an inverse scale was given)."""

    def __init__(self, buf, count):
        self.buf = buf
        self.count = count

    @property
    def total(self):
        return self.buf[0]

    @property
    def nonfinite(self):
        return self.buf[1]

    @property
    def coef(self):
        return self.buf[2]

    @property
    def skip(self):
        return self.buf[3]

    @property
    def sq(self):
        return self.buf[4:4 + self.count]

    def finite(self):
        """Whether every value was finite (reads one float back)."""
        return float(self.buf[1]) == 0.0


@torch.no_grad()
def grad_sumsq_reference(grads, inv=None, clip_norm=0.0,
                         skip_nonfinite=False):
    """Plain version of :func:`grad_sumsq`: per gradient, ``sum(x * x)``
    in fp32 of ``x = G(g * inv)`` (or ``g``), added in list order as the
    JAX clips add them."""
    t = len(grads)
    dev = grads[0].device if grads else torch.device("cpu")
    buf = torch.zeros(4 + 2 * t, dtype=torch.float32, device=dev)
    total = torch.zeros((), dtype=torch.float32, device=dev)
    bad = torch.zeros((), dtype=torch.float32, device=dev)
    for i, g in enumerate(grads):
        x = g.float()
        if inv is not None:
            x = _round(x * inv, g.dtype)
        s = torch.sum(x * x)
        nb = torch.sum(~torch.isfinite(x)).float()
        buf[4 + i] = s
        buf[4 + t + i] = nb
        total = s if i == 0 else total + s
        bad = bad + nb
    buf[0] = total
    buf[1] = bad
    if clip_norm > 0:
        n = torch.sqrt(total)
        c = torch.div(_scalar(_F32(clip_norm), n), torch.clamp(n, min=1e-12))
        buf[2] = torch.clamp(c, max=1.0)
    else:
        buf[2] = 1.0
    buf[3] = (bad > 0).float() if skip_nonfinite else 0.0
    return GradStats(buf, t)


@torch.no_grad()
def grad_sumsq(grads, inv=None, clip_norm=0.0, skip_nonfinite=False):
    """The sums of squares of ``grads`` (each fp32, bf16 or fp16), each
    value first unscaled to ``G(g * inv)`` when ``inv`` (an fp32 one-element
    tensor) is given; the global-norm clip coefficient ``min(1, clip_norm /
    max(sqrt(total), 1e-12))`` when ``clip_norm`` > 0 (else 1); the skip
    flag set when ``skip_nonfinite`` and a value is not finite. Returns a
    :class:`GradStats`; nothing is read back."""
    grads = list(grads)
    if not grads or grads[0].device.type == "cpu":
        return grad_sumsq_reference(grads, inv, clip_norm, skip_nonfinite)
    return grad_sumsq_cuda(grads, inv, clip_norm, skip_nonfinite)


# -------------------------------------------------------------- prologue
class Prologue:
    """What an update does to each gradient before it, in the JAX step's
    order (``trainer.py:394-460``):

    1. ``inv`` (an fp32 one-element tensor): the loss scaler's unscale,
       ``G(g * inv)``;
    2. ``clip``: ``CLIP_GLOBAL``, ``G(g * stats.coef)``; ``CLIP_NORM``,
       per tensor ``G(g * s)`` with ``n = G(sqrt(stats.sq[slot]))`` and
       ``s = n > c ? G(c / max(n, 1e-12)) : 1`` in g's type
       (``optimizer/clip.py:44-47``); ``CLIP_VALUE``, ``clamp(g, lo,
       hi)``;
    3. the decay the update call names (L2 ``G(g + wd * p)``, L1 ``G(g +
       coeff * sign(p))``);

    and, with ``skip``, no write at all when ``stats.skip`` is set.
    ``G(x)`` rounds to the gradient's type. ``stats`` is the
    :class:`GradStats` the clip or the skip reads; an update call's
    ``slots`` index its per-tensor sums."""

    def __init__(self, inv=None, clip=CLIP_NONE, stats=None, clip_norm=0.0,
                 lo=0.0, hi=0.0, skip=False):
        if clip in (CLIP_GLOBAL, CLIP_NORM) or skip:
            if stats is None:
                raise ValueError("the global and per-tensor clips and the "
                                 "skip flag read a GradStats")
        if clip not in (CLIP_NONE, CLIP_GLOBAL, CLIP_NORM, CLIP_VALUE):
            raise ValueError(f"unknown clip kind {clip!r}")
        self.inv = None if inv is None else inv.reshape(())
        self.clip = clip
        self.stats = stats
        self.clip_norm = float(clip_norm)
        self.lo = float(lo)
        self.hi = float(hi)
        self.skip = bool(skip)

    def skipped(self):
        """The plain versions' skip test (reads the flag back)."""
        return self.skip and float(self.stats.skip) != 0.0


NO_PROLOGUE = Prologue()


def _prep_reference(g, p32, pro, slot, decay_kind, decay):
    """The prologue of one gradient, plain (see :class:`Prologue`)."""
    dt = g.dtype
    g32 = g.float()
    if pro.inv is not None:
        g32 = _round(g32 * pro.inv, dt)
    if pro.clip == CLIP_GLOBAL:
        g32 = _round(g32 * pro.stats.coef, dt)
    elif pro.clip == CLIP_NORM:
        n = _round(torch.sqrt(pro.stats.sq[slot]), dt)
        c = _scalar(in_type(pro.clip_norm, dt), n)
        d = torch.div(c, torch.clamp(n, min=in_type(1e-12, dt)))
        s = torch.where(n > c, _round(d, dt), torch.ones_like(n))
        g32 = _round(g32 * s, dt)
    elif pro.clip == CLIP_VALUE:
        g32 = torch.clamp(g32, in_type(pro.lo, dt), in_type(pro.hi, dt))
    if decay_kind == DECAY_L2:
        g32 = _round(g32 + decay * p32, dt)
    elif decay_kind == DECAY_L1:
        sign = (p32 > 0).float() - (p32 < 0).float()
        g32 = _round(g32 + decay * sign, dt)
    return g32


def _decay_args(weight_decay, l1):
    """(kind, coefficient as an fp32-rounded float) of the prologue's
    decay: L1 when ``l1`` is nonzero, else L2 when ``weight_decay`` is."""
    if l1:
        return DECAY_L1, float(_F32(l1))
    if weight_decay:
        return DECAY_L2, float(_F32(weight_decay))
    return DECAY_NONE, 0.0


# -------------------------------------------------------------- adam
def adam_hyper(lr, beta1, beta2, eps, t, weight_decay, decoupled):
    """The fp32 scalars of one Adam step, computed on the host as
    ``_adam_update`` rounds them (``optimizer.py:44-56``): lr, beta1,
    beta2, 1 - beta1, 1 - beta2, the bias corrections 1 - beta^t (numpy
    fp32 power at a float step count), eps, the coupled decay (Adam; 0 for
    AdamW) and 1 - lr * wd (AdamW)."""
    lr, b1, b2 = _F32(lr), _F32(beta1), _F32(beta2)
    t, wd, one = _F32(t), _F32(weight_decay), _F32(1)
    return [float(x) for x in (
        lr, b1, b2, one - b1, one - b2, one - np.power(b1, t),
        one - np.power(b2, t), _F32(eps), _F32(0) if decoupled else wd,
        one - lr * wd)]


def _adam_reference_one(p, m, v, g, h, decoupled, pro, slot, decay_kind,
                        decay):
    lr, b1, b2, omb1, omb2, bc1, bc2, eps, l2, dec = h
    p32 = p.float()
    g32 = _prep_reference(g, p32, pro, slot, decay_kind, decay)
    if l2:
        g32 = g32 + l2 * p32
    m2 = b1 * m + omb1 * g32
    v2 = b2 * v + omb2 * (g32 * g32)
    mhat = m2 / _scalar(bc1, m)
    vhat = v2 / _scalar(bc2, v)
    step = (lr * mhat) / (torch.sqrt(vhat) + eps)
    if decoupled:
        p32 = p32 * dec
    p.copy_(p32 - step)
    m.copy_(m2)
    v.copy_(v2)


@torch.no_grad()
def fused_adam_update_reference(params, m, v, grads, lr, beta1, beta2, eps,
                                t, decoupled=False, weight_decay=0.0, *,
                                l1=0.0, prologue=None, slots=None):
    """Plain version of :func:`fused_adam_update`."""
    pro = prologue or NO_PROLOGUE
    if pro.skipped():
        return params, m, v
    h = adam_hyper(lr, beta1, beta2, eps, t, 0.0 if l1 else weight_decay,
                   decoupled)
    kind, coeff = _decay_args(0.0, l1)
    slots = range(len(params)) if slots is None else slots
    for p, m_, v_, g, s in zip(params, m, v, grads, slots):
        _adam_reference_one(p, m_, v_, g, h, decoupled, pro, s, kind, coeff)
    return params, m, v


@torch.no_grad()
def fused_adam_update(params, m, v, grads, lr, beta1, beta2, eps, t,
                      decoupled=False, weight_decay=0.0, *, l1=0.0,
                      prologue=None, slots=None):
    """One Adam (``decoupled=False``) or AdamW step of every parameter in
    ``params`` with its fp32 moments ``m``, ``v`` and gradient, in place,
    in ``_adam_update``'s op order; the argument order is the JAX
    package's (``paddle_tpu/kernels/fused_adam.py:21``). ``l1`` adds JAX's
    ``_apply_l1`` term first (the weight decay is then 0, as the eager Adam
    does); ``prologue`` and ``slots`` as in :class:`Prologue`. Returns
    ``(params, m, v)``."""
    params, m, v, grads = list(params), list(m), list(v), list(grads)
    if not params:
        return params, m, v
    if params[0].device.type == "cpu":
        return fused_adam_update_reference(
            params, m, v, grads, lr, beta1, beta2, eps, t, decoupled,
            weight_decay, l1=l1, prologue=prologue, slots=slots)
    return fused_adam_update_cuda(
        params, m, v, grads, lr, beta1, beta2, eps, t, decoupled,
        weight_decay, l1=l1, prologue=prologue, slots=slots)


# ---------------------------------------------------------- momentum
@torch.no_grad()
def momentum_update_reference(params, velocity, grads, lr, momentum=0.0,
                              use_nesterov=False, *, weight_decay=0.0,
                              l1=0.0, prologue=None, slots=None):
    """Plain version of :func:`momentum_update`."""
    pro = prologue or NO_PROLOGUE
    if pro.skipped():
        return params, velocity
    lr, mu = float(_F32(lr)), float(_F32(momentum))
    kind, coeff = _decay_args(weight_decay, l1)
    vel = [None] * len(params) if velocity is None else velocity
    slots = range(len(params)) if slots is None else slots
    for p, b, g, s in zip(params, vel, grads, slots):
        p32 = p.float()
        g32 = _prep_reference(g, p32, pro, s, kind, coeff)
        upd = g32
        if b is not None:
            v2 = mu * b + g32
            upd = g32 + mu * v2 if use_nesterov else v2
            b.copy_(v2)
        p.copy_(p32 - lr * upd)
    return params, velocity


@torch.no_grad()
def momentum_update(params, velocity, grads, lr, momentum=0.0,
                    use_nesterov=False, *, weight_decay=0.0, l1=0.0,
                    prologue=None, slots=None):
    """SGD (``velocity`` None: ``p - lr * g``, ``_sgd_update``) or
    Momentum (``v2 = mu * v + g``; ``p - lr * (g + mu * v2)`` with
    Nesterov, else ``p - lr * v2``; ``_momentum_update``) of every
    parameter in place, after the prologue and the L2 (``weight_decay``:
    ``G(g + wd * p)``, as the trainer adds it) or L1 decay. Returns
    ``(params, velocity)``."""
    params, grads = list(params), list(grads)
    velocity = None if velocity is None else list(velocity)
    if not params:
        return params, velocity
    fn = (momentum_update_reference if params[0].device.type == "cpu"
          else momentum_update_cuda)
    return fn(params, velocity, grads, lr, momentum, use_nesterov,
              weight_decay=weight_decay, l1=l1, prologue=prologue,
              slots=slots)


# -------------------------------------------------------------- lamb
def lamb_hyper(lr, beta1, beta2, eps, t, lamb_weight_decay):
    """The fp32 scalars of one Lamb step (``optimizer.py:60-72``): lr,
    beta1, beta2, 1 - beta1, 1 - beta2, the bias corrections, eps, the
    Lamb weight decay."""
    h = adam_hyper(lr, beta1, beta2, eps, t, 0.0, True)[:8]
    return h + [float(_F32(lamb_weight_decay))]


@torch.no_grad()
def lamb_update_reference(params, m, v, grads, lr, beta1, beta2, eps, t,
                          lamb_weight_decay, *, prologue=None, slots=None):
    """Plain version of :func:`lamb_update`."""
    pro = prologue or NO_PROLOGUE
    if pro.skipped():
        return params, m, v
    lr_, b1, b2, omb1, omb2, bc1, bc2, eps_, wd = lamb_hyper(
        lr, beta1, beta2, eps, t, lamb_weight_decay)
    slots = range(len(params)) if slots is None else slots
    for p, m_, v_, g, s in zip(params, m, v, grads, slots):
        p32 = p.float()
        g32 = _prep_reference(g, p32, pro, s, DECAY_NONE, 0.0)
        m2 = b1 * m_ + omb1 * g32
        v2 = b2 * v_ + omb2 * (g32 * g32)
        mhat = m2 / _scalar(bc1, m_)
        vhat = v2 / _scalar(bc2, v_)
        r = mhat / (torch.sqrt(vhat) + eps_) + wd * p32
        w_norm = torch.sqrt(torch.sum(p32 * p32))
        r_norm = torch.sqrt(torch.sum(r * r))
        ratio = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones_like(w_norm))
        p.copy_(p32 - (lr_ * ratio) * r)
        m_.copy_(m2)
        v_.copy_(v2)
    return params, m, v


@torch.no_grad()
def lamb_update(params, m, v, grads, lr, beta1, beta2, eps, t,
                lamb_weight_decay, *, prologue=None, slots=None):
    """One Lamb step of every parameter in place: the moments as Adam's,
    ``r = mhat / (sqrt(vhat) + eps) + wd * p``, then ``p - lr * ratio *
    r`` with ``ratio = |p| / |r|`` per tensor when both norms are above 0,
    else 1. Returns ``(params, m, v)``."""
    params, m, v, grads = list(params), list(m), list(v), list(grads)
    if not params:
        return params, m, v
    fn = (lamb_update_reference if params[0].device.type == "cpu"
          else lamb_update_cuda)
    return fn(params, m, v, grads, lr, beta1, beta2, eps, t,
              lamb_weight_decay, prologue=prologue, slots=slots)


# ----------------------------------------------------------- the kernels
def _check_rows(name, rows, fp32_cols):
    """Every tensor of ``rows`` (tuples: parameter, gradient, state...) on
    one CUDA device, dense, with its row's numel; parameters and gradients
    fp32, bf16 or fp16 (not bf16 beside fp16), the state columns fp32."""
    dev = rows[0][0].device
    if dev.type != "cuda":
        raise ValueError(f"{name} kernel needs CUDA tensors, got {dev}")
    for row in rows:
        n = row[0].numel()
        for j, x in enumerate(row):
            if x is None:
                continue
            if x.device != dev:
                raise ValueError(f"{name} kernel needs one CUDA device, got "
                                 f"{dev} and {x.device}")
            if x.numel() != n:
                raise ValueError(f"{name} kernel: a tensor of {x.numel()} "
                                 f"elements beside its parameter's {n}")
            if not x.is_contiguous():
                raise ValueError(f"{name} kernel needs dense tensors")
            want = (torch.float32,) if j in fp32_cols else _TYPES
            if x.dtype not in want:
                raise TypeError(f"{name} kernel takes {want} in column {j}, "
                                f"got {x.dtype}")
        if len(row) > 1 and row[1] is not None and {
                row[0].dtype, row[1].dtype} == {torch.bfloat16,
                                                torch.float16}:
            raise TypeError(f"{name} kernel takes no bf16 parameter with an "
                            f"fp16 gradient or the reverse")
    return dev


def _pointer_table(rows):
    depth = len(rows[0])
    flat = [None if x is None else x.data_ptr() for row in rows for x in row]
    ptrs = (ctypes.c_void_p * (len(rows) * depth))(*flat)
    numel = (ctypes.c_longlong * len(rows))(*[row[0].numel() for row in rows])
    return ptrs, numel


def _prologue_args(pro, g_dtype, decay_kind, decay):
    """The C entry points' prologue arrays for gradients of ``g_dtype``:
    the device pointers (inv, coef, sq, skip), the floats (clip_norm, lo,
    hi in g's type, the decay coefficient) and the ints (clip, decay
    kind)."""
    stats = pro.stats

    def ptr(x):
        return None if x is None else x.data_ptr()

    ptrs = (ctypes.c_void_p * 4)(
        ptr(pro.inv),
        ptr(stats.coef) if pro.clip == CLIP_GLOBAL else None,
        ptr(stats.sq) if pro.clip == CLIP_NORM else None,
        ptr(stats.skip) if pro.skip else None)
    floats = (ctypes.c_float * 4)(
        in_type(pro.clip_norm, g_dtype), in_type(pro.lo, g_dtype),
        in_type(pro.hi, g_dtype), decay)
    ints = (ctypes.c_int * 2)(pro.clip, decay_kind)
    return ptrs, floats, ints


def _check_prologue(pro, dev):
    for x in (pro.inv, None if pro.stats is None else pro.stats.buf):
        if x is not None and (x.device != dev or x.dtype != torch.float32):
            raise ValueError(f"the prologue's buffers must be fp32 on {dev}, "
                             f"got {x.dtype} on {x.device}")


def _by_types(rows, slots):
    """(p dtype, g dtype) -> (rows, slots), in list order."""
    groups = {}
    for row, s in zip(rows, slots):
        rs, ss = groups.setdefault((row[0].dtype, row[1].dtype), ([], []))
        rs.append(row)
        ss.append(s)
    return groups


def _launch(name, fn, rows, slots, pro, decay_kind, decay, *tail):
    """Calls the C entry point ``fn`` once per (p, g) dtype pair of
    ``rows``; returns the kernels it launched, and of those the ones over
    fp16 tensors."""
    total = fp16 = 0
    for (pd, gd), (rs, ss) in _by_types(rows, slots).items():
        ptrs, numel = _pointer_table(rs)
        sl = (ctypes.c_int * len(ss))(*ss)
        pp, pf, pi = _prologue_args(pro, gd, decay_kind, decay)
        launches = ctypes.c_int(0)
        with torch.cuda.device(rs[0][0].device):
            err = fn(ptrs, numel, sl, len(rs), _build.DTYPE_CODES[pd],
                     _build.DTYPE_CODES[gd], pp, pf, pi, *tail,
                     ctypes.byref(launches), _build.stream_of(rs[0][0]))
        _build.check(err, name)
        total += launches.value
        if torch.float16 in (pd, gd):
            fp16 += launches.value
    return total, fp16


def _slots(slots, n):
    slots = list(range(n)) if slots is None else [int(s) for s in slots]
    if len(slots) != n or min(slots) < 0:
        raise ValueError(f"slots must be {n} indices >= 0")
    return slots


def grad_sumsq_cuda(grads, inv=None, clip_norm=0.0, skip_nonfinite=False):
    """Launch ``mt_sumsq`` (see :func:`grad_sumsq`)."""
    global sumsq_launches, fp16_sumsq_launches
    dev = _check_rows("mt_sumsq", [(g,) for g in grads], ())
    if inv is not None and (inv.device != dev or inv.dtype != torch.float32):
        raise ValueError("inv must be an fp32 tensor on the gradients' "
                         "device")
    lib = _build.load()
    t = len(grads)
    chunks = sum(-(-g.numel() // CHUNK) for g in grads)
    buf = torch.empty(4 + 2 * t, dtype=torch.float32, device=dev)
    partial = torch.empty(max(2 * chunks, 1), dtype=torch.float32,
                          device=dev)
    ptrs, numel = _pointer_table([(g,) for g in grads])
    dtypes = (ctypes.c_int * t)(*[_build.DTYPE_CODES[g.dtype] for g in grads])
    launches = ctypes.c_int(0)
    with torch.cuda.device(dev):
        err = lib.ptt_mt_sumsq(
            ptrs, numel, dtypes, t, None if inv is None else inv.data_ptr(),
            _build.ptr(buf), _build.ptr(partial), chunks,
            float(_F32(clip_norm)), int(bool(skip_nonfinite)),
            ctypes.byref(launches), _build.stream_of(buf))
    _build.check(err, "ptt_mt_sumsq")
    sumsq_launches += launches.value
    if any(g.dtype == torch.float16 for g in grads):
        fp16_sumsq_launches += launches.value
    return GradStats(buf, t)


def fused_adam_update_cuda(params, m, v, grads, lr, beta1, beta2, eps, t,
                           decoupled=False, weight_decay=0.0, *, l1=0.0,
                           prologue=None, slots=None):
    """Launch ``mt_adam`` (see :func:`fused_adam_update`)."""
    global adam_launches, fp16_adam_launches
    pro = prologue or NO_PROLOGUE
    rows = list(zip(params, grads, m, v))
    dev = _check_rows("mt_adam", rows, (2, 3))
    _check_prologue(pro, dev)
    lib = _build.load()
    h = adam_hyper(lr, beta1, beta2, eps, t, 0.0 if l1 else weight_decay,
                   decoupled)
    kind, coeff = _decay_args(0.0, l1)
    n, n16 = _launch(
        "ptt_mt_adam", lib.ptt_mt_adam, rows, _slots(slots, len(rows)), pro,
        kind, coeff, (ctypes.c_float * 10)(*h), int(bool(decoupled)))
    adam_launches += n
    fp16_adam_launches += n16
    return params, m, v


def momentum_update_cuda(params, velocity, grads, lr, momentum=0.0,
                         use_nesterov=False, *, weight_decay=0.0, l1=0.0,
                         prologue=None, slots=None):
    """Launch ``mt_momentum`` (see :func:`momentum_update`)."""
    global momentum_launches
    pro = prologue or NO_PROLOGUE
    vel = [None] * len(params) if velocity is None else velocity
    rows = list(zip(params, grads, vel))
    dev = _check_rows("mt_momentum", rows, (2,))
    _check_prologue(pro, dev)
    lib = _build.load()
    kind, coeff = _decay_args(weight_decay, l1)
    momentum_launches += _launch(
        "ptt_mt_momentum", lib.ptt_mt_momentum, rows,
        _slots(slots, len(rows)), pro, kind, coeff, float(_F32(lr)),
        float(_F32(momentum)), int(bool(use_nesterov)))[0]
    return params, velocity


def lamb_update_cuda(params, m, v, grads, lr, beta1, beta2, eps, t,
                     lamb_weight_decay, *, prologue=None, slots=None):
    """Launch ``mt_lamb`` (see :func:`lamb_update`)."""
    global lamb_launches
    pro = prologue or NO_PROLOGUE
    rows = list(zip(params, grads, m, v))
    dev = _check_rows("mt_lamb", rows, (2, 3))
    _check_prologue(pro, dev)
    lib = _build.load()
    chunks = sum(-(-p.numel() // CHUNK) for p in params)
    # each call's r^2 and p^2 sums by the tensor's position in the call
    sums = torch.empty(2 * len(rows), dtype=torch.float32, device=dev)
    partial = torch.empty(max(2 * chunks, 1), dtype=torch.float32,
                          device=dev)
    h = lamb_hyper(lr, beta1, beta2, eps, t, lamb_weight_decay)
    lamb_launches += _launch(
        "ptt_mt_lamb", lib.ptt_mt_lamb, rows, _slots(slots, len(rows)), pro,
        DECAY_NONE, 0.0, (ctypes.c_float * 9)(*h), _build.ptr(sums),
        _build.ptr(partial), chunks)[0]
    return params, m, v
