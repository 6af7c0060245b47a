"""Fused rotary embedding + attention: the hand-written Hopper kernel (a
rope-on-load variant of the flash attention forward) and its plain
version.

Counterpart of ``paddle_tpu/kernels/fused_rope_attention.py``
(``rope_attention_fused``, a ``jax.custom_vjp`` over
``_rope_attention``, whose TPU kernel is ``_fused_kernel``;
``rope_attention_composed`` and ``_composed_2d_tables`` for the plain
version). The CUDA source is ``ptt_rope_attention_fwd`` in
``paddle_tpu_torch/csrc/flash_attention.cu``; its header says what bounds
it on the H100 and how the design answers that.

Shape contract (as the TPU module's): q, k, v ``[B, S, H, D]`` of one
shape (MHA self-attention), cos/sin the half-dim rope tables ``[1, S, 1,
D/2]`` (``rope.build_rope_cache``) or ``[S, D/2]``. Everything is fp32
from the load on: q and k are rotated by the tables (``_rotate``), the
scores softmaxed exactly with the causal mask ``cols <= rows``
(``_attn_rows``), ``P @ V`` summed in fp32, and the output cast once to
q's dtype. The rotated q and k and P are never rounded.

:func:`rope_attention_fused` is a ``torch.autograd.Function``. Its
forward runs the kernel on a CUDA tensor (or raises) and the plain
version on a CPU tensor. Its backward (:func:`rope_attention_backward`)
is the JAX package's ``_bwd``: the VJP of ``_composed_2d_tables``,
recomputed from the saved inputs. It is composed of the port's own
kernels through their wrappers, in fp32 from end to end: q and k cast to
fp32 and rotated by the rope kernel, the split flash forward recomputing
the fp32 O and its LSE (the fused forward stores neither), the split
flash backward on the rotated q and k, v and the gradient cast to fp32
(Delta from that fp32 O), the rope backward kernel (-sin) on d(rq) and
d(rk), and one cast of dq, dk, dv to the inputs' dtypes. Nothing the
JAX ``_bwd`` keeps in fp32 is rounded: the flash kernels' rounding
points (P and dS to the inputs' dtype) are no-ops in fp32. A CPU tensor
runs the same composition through the plain versions of those kernels
(``rope_reference``, ``flash_attention_reference``,
``flash_attention_backward_reference``, ``rope_backward_reference``);
autograd through the plain forward is only the tests' oracle. The
tables get no gradient.

In the port this kernel runs where the model selects the fusion
(``LlamaForCausalLM(fusions={"rope_attention"})``): the JAX package
selects its TPU kernel through the tune cache
(``rope_attention_select``), which is not ported. The TPU kernel's
``S % block_q`` restriction is a tiling artefact and is not ported: the
kernel takes any S and masks the ragged tail.

Two designs, chosen by dtype and head dim (:func:`design`): bf16 and
fp16 whose padded head dim is 64 to 128 run the tensor-core kernel
(``"tc"``, ``tc::rope_attention_fwd_tc_kernel``), which keeps the fp32
contract by splitting each rotated q and k value and each probability
into bf16 hi and lo parts (five bf16 products, fp32 accumulators;
:func:`split_product_slack` bounds what that moves; an fp16 v is split
into its two exact bf16 parts too, so its P V is four products of parts
and the bound stays); every other case (fp32 at every head dim, bf16
and fp16 below a padded 64 and above 128) runs the split design
(``"split"``): a pre-pass rotates q and k in fp32 in ``_rotate``'s op
order and writes each rotated value as three bf16 parts (all 24 bits:
nothing is rounded; a 16-bit input is cast to fp32 first, exactly) into
the bf16 workspace that flash attention's split forward reads, v is
split the same way, and that forward (six bf16 products a product; at a
padded head dim above 128 a pair of CTAs, each on half of the head dim)
runs on them with no LSE stored and writes O in the inputs' dtype. So
bf16 and fp16 outside 64 to 128 keep the fp32 contract exactly, with no
slack. ``cuda_cores=True`` runs the CUDA-core kernel
(fp32 FMAs) at any head dim and dtype (the design the tensor-core ones
replaced, kept to compare with). ``tc_launches``, ``split_launches`` and
``cc_launches`` count each design beside ``launches``; ``bwd_launches``
counts the backward's compositions on a CUDA tensor; ``fp16_launches``
and ``fp16_bwd_launches`` the calls of each on fp16 inputs (the fp16
backward casts once to fp32, as every dtype's does). A head dim
that is not a multiple of 16 is padded into a copy half by half
(``[x1, 0, x2, 0]``, the tables with zero columns), so column c still
pairs with c + D/2 of the true D, and the output is sliced back.
"""
from __future__ import annotations

import functools
import math

import torch

from ..amp import naninf as _naninf
from . import _build
from . import flash_attention as _flash
from . import rope as _rope
from .flash_attention import (TC_MIN_HEAD_DIM, check_head_dim,
                              flash_attention_backward_reference,
                              flash_attention_reference, padded_head_dim,
                              split_workspace_elems)
from .rope import (pad_halves, rope_backward_reference, rope_reference,
                   unpad_halves)

# launches, and the same by design: tensor cores (bf16 at a padded head
# dim of 64 to 128), split products on the tensor cores (the rest), CUDA
# cores (on request); and the backward's compositions on a CUDA tensor
launches = 0
tc_launches = 0
split_launches = 0
cc_launches = 0
bwd_launches = 0
fp16_launches = 0
fp16_bwd_launches = 0
DESIGN_COUNTERS = ("tc_launches", "split_launches", "cc_launches",
                   "bwd_launches")
TC_MAX_HEAD_DIM = 128


def design(dtype, head_dim):
    """``"tc"`` (tensor cores, bf16 hi/lo products; bf16 and fp16 inputs)
    or ``"split"`` (the
    rotate-and-split pre-pass and flash attention's split forward): the
    design ``ptt_rope_attention_fwd`` runs for this dtype and head dim
    (the CUDA cores run only on request)."""
    padded = padded_head_dim(head_dim)
    if dtype in (torch.bfloat16, torch.float16) \
            and TC_MIN_HEAD_DIM <= padded <= TC_MAX_HEAD_DIM:
        return "tc"
    return "split"


def _table_2d(t):
    """``[1, S, 1, D/2]`` or ``[S, D/2]`` -> a ``[S, D/2]`` view."""
    if t.dim() == 4:
        t = t.reshape(int(t.shape[1]), int(t.shape[3]))
    if t.dim() != 2:
        raise ValueError(f"rope table must be [1, S, 1, D/2] or [S, D/2], "
                         f"got {tuple(t.shape)}")
    return t


def _rotate(x, cos, sin):
    """Neox rotation, fp32 in and out (``fused_rope_attention.py:58-66``)."""
    d2 = int(x.shape[-1]) // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attn_rows(s, causal, scale):
    """Score rows -> exact softmax weights, fp32 (``:69-81``)."""
    s = s * scale
    if causal:
        n_r, n_c = int(s.shape[-2]), int(s.shape[-1])
        keep = torch.ones((n_r, n_c), dtype=torch.bool,
                          device=s.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    return p / p.sum(dim=-1, keepdim=True)


def _check(q, k, v, cos, sin):
    if q.dim() != 4 or tuple(k.shape) != tuple(q.shape) \
            or tuple(v.shape) != tuple(q.shape):
        raise ValueError(
            f"fused rope+attention is MHA self-attention only: q, k, v of "
            f"one [B, S, H, D] shape, got q {tuple(q.shape)} k "
            f"{tuple(k.shape)} v {tuple(v.shape)}")
    s, d = int(q.shape[1]), int(q.shape[3])
    if d % 2:
        raise ValueError(f"rope needs an even head_dim, got {d}")
    cos2, sin2 = _table_2d(cos), _table_2d(sin)
    if tuple(cos2.shape) != (s, d // 2) or tuple(sin2.shape) != (s, d // 2):
        raise ValueError(f"rope tables must cover [S={s}, D/2={d // 2}], got "
                         f"{tuple(cos2.shape)}/{tuple(sin2.shape)}")
    return cos2, sin2


def _scale_of(q, scale):
    return 1.0 / math.sqrt(int(q.shape[-1])) if scale is None \
        else float(scale)


def _composed(q, k, v, cos2, sin2, causal, scale):
    """``_composed_2d_tables``' op order on ``[S, D/2]`` tables."""
    qt, kt, vt = (t.transpose(1, 2).float() for t in (q, k, v))
    c = cos2.float()[None, None]
    s = sin2.float()[None, None]
    rq = _rotate(qt, c, s)
    rk = _rotate(kt, c, s)
    p = _attn_rows(torch.matmul(rq, rk.transpose(-1, -2)), causal, scale)
    return torch.matmul(p, vt).to(q.dtype).transpose(1, 2)


def split_product_slack(q, k, v, cos, sin, causal=True, scale=None):
    """Per output entry ``[B, S, H, D]`` (fp32), how far the tensor-core
    kernel's split products may move the output from the fp32 function
    before its final cast.

    Derivation. bf16 keeps 8 significant bits, so rounding to it moves x
    by at most ``u |x|``, ``u = 2^-8``. The kernel writes an fp32 value x
    as ``hi = bf16(x)`` and ``lo = bf16(x - hi)``; ``x - hi`` is exact,
    so ``|x - hi - lo| <= u^2 |x| = 2^-16 |x|`` and ``|lo| <= u (1 + u)
    |x|``. With q = q_hi + q_lo + e_q and k likewise, ``q . k`` minus the
    three products the kernel takes (``q_hi k_hi + q_hi k_lo + q_lo
    k_hi``) is ``q_lo k_lo + e_q k + (q_hi + q_lo) e_k`` term by term:
    at most ``(u^2 (1 + u)^2 + 2^-16 + 2^-16 (1 + u)) |q_c| |k_c|``, under
    ``3.02 * 2^-16 |q_c| |k_c|``. The tensor cores' fp32 sums over the
    ``3 D / 16`` k-steps add at most ``2^-23`` of the running sum of
    absolute values each, ``3 D / 16 * 2^-23 = 0.19 * 2^-16`` at D 128.
    So each scaled score moves by at most ``E_rc = 2^-14 scale sum_c
    |q_rc| |k_c|`` (the rotated q and k). A perturbation ``delta`` of the
    scores, ``|delta_c| <= E_c``, scales ``p_c`` by ``e^delta_c / sum_j
    p_j e^delta_j``, which lies within ``e^(+-(E_c + F))``, ``F = sum_j
    p_j (e^E_j - 1)`` (Jensen above, ``1 + x <= e^x`` below), so the
    output moves by at most ``sum_c p_c (e^(E_c + F) - 1) |v_c|``. P is
    split the same way: ``P_hi + P_lo`` is within ``2^-16 p_c`` of p_c;
    the hardware exp2 (2 ulp) and the fp32 scaling of the scores move
    each p_c by under ``2^-20`` of itself; and the fp32 sums of P V over
    the row's n keys add at most ``n 2^-24`` of ``sum_c p_c |v_c|``: that
    adds ``(2^-16 + 2^-20 + n 2^-24) sum_c p_c |v_c|``. The plain
    version's own fp32 sums are covered by the same terms."""
    cos2, sin2 = _check(q, k, v, cos, sin)
    scale = _scale_of(q, scale)
    qt, kt, vt = (t.transpose(1, 2).float() for t in (q, k, v))
    c = cos2.float()[None, None]
    s = sin2.float()[None, None]
    rq, rk = _rotate(qt, c, s), _rotate(kt, c, s)
    e = 2.0 ** -14 * scale * torch.matmul(rq.abs(), rk.abs().transpose(-1, -2))
    p = _attn_rows(torch.matmul(rq, rk.transpose(-1, -2)), bool(causal), scale)
    f = (p * torch.expm1(e)).sum(-1, keepdim=True)
    n = int(q.shape[1])
    w = p * (torch.expm1(e + f) + 2.0 ** -16 + 2.0 ** -20 + n * 2.0 ** -24)
    return torch.matmul(w, vt.abs()).transpose(1, 2)


def rope_attention_reference(q, k, v, cos, sin, causal=True, scale=None):
    """Plain PyTorch version, in ``_composed_2d_tables``' order:
    everything fp32, rotate, scores, exact softmax, ``P @ V``, one
    cast. Returns ``[B, S, H, D]`` in q's dtype."""
    cos2, sin2 = _check(q, k, v, cos, sin)
    return _composed(q, k, v, cos2, sin2, bool(causal), _scale_of(q, scale))


def _forward(q, k, v, cos2, sin2, causal, scale):
    if q.device.type == "cpu":
        return _composed(q, k, v, cos2, sin2, causal, scale)
    return rope_attention_cuda(q, k, v, cos2, sin2, causal, scale)


class _RopeAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, cos2, sin2, causal, scale):
        out = _naninf.kernel_op("rope_attention", _forward, q, k, v, cos2,
                                sin2, causal, scale)
        ctx.save_for_backward(q, k, v, cos2, sin2)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, cos2, sin2 = ctx.saved_tensors
        dq, dk, dv = _naninf.kernel_op(
            "rope_attention", rope_attention_backward, q, k, v, g, cos2,
            sin2, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None, None


def _kernel_steps():
    """The backward's four steps on a CUDA tensor: the port's kernels."""
    return (_rope.rope_cuda, _flash.flash_attention_cuda,
            _flash.flash_attention_backward_cuda,
            functools.partial(_rope.rope_cuda, inverse=True))


def _plain_steps():
    """The same four steps on a CPU tensor: the kernels' plain versions
    (looked up when called, so that a test may replace one)."""
    return (lambda q, k, c, s: (rope_reference(q, c, s),
                                rope_reference(k, c, s)),
            flash_attention_reference, flash_attention_backward_reference,
            lambda q, k, c, s: (rope_backward_reference(q, c, s),
                                rope_backward_reference(k, c, s)))


def rope_attention_backward(q, k, v, g, cos2, sin2, causal, scale):
    """``(dq, dk, dv)``: the VJP of :func:`rope_attention_reference` at
    q, k, v for the output gradient ``g`` (the JAX ``_bwd``), composed of
    the port's kernels on a CUDA tensor (or a raise) and of their plain
    versions on the CPU, all in fp32: rotate q and k, the flash forward
    for O and LSE, the flash backward, the rope backward, one cast."""
    global bwd_launches, fp16_bwd_launches
    cuda = q.device.type == "cuda"
    rope_fwd, flash_fwd, flash_bwd, rope_bwd = (
        _kernel_steps() if cuda else _plain_steps())
    tables = [t.float().reshape(1, t.shape[0], 1, t.shape[1])
              for t in (cos2, sin2)]
    f32 = [t.float().contiguous() for t in (q, k, v, g)]
    rq, rk = rope_fwd(f32[0], f32[1], *tables)
    del f32[:2]
    o, lse = flash_fwd(rq, rk, f32[0], causal, scale)
    drq, drk, dv = flash_bwd(rq, rk, f32[0], o, lse, f32[1], causal, scale)
    del rq, rk, o, lse, f32
    dq, dk = rope_bwd(drq, drk, *tables)
    del drq, drk
    if cuda:
        bwd_launches += 1
        fp16_bwd_launches += q.dtype == torch.float16
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def rope_attention_fused(q, k, v, cos, sin, causal=True, scale=None):
    """Rotate q and k by the tables, then attention; differentiable in q,
    k and v. Routes on q's device (CPU: the plain version; CUDA: the
    kernel, or a raise)."""
    cos2, sin2 = _check(q, k, v, cos, sin)
    return _RopeAttention.apply(q, k, v, cos2, sin2, bool(causal),
                                _scale_of(q, scale))


def _strides(t, name, vec):
    if t.stride(-1) != 1:
        raise ValueError(f"rope attention: {name}'s last axis must be "
                         f"contiguous, got strides {tuple(t.stride())}")
    st = [int(x) for x in t.stride()[:3]]
    if any(x % vec for x in st) or t.data_ptr() % 16:
        raise ValueError(
            f"rope attention reads {name} in 16-byte vectors: its strides "
            f"{tuple(st)} must be multiples of {vec} and its data 16-byte "
            f"aligned")
    return st


def padded_rope_attention(fn, q, k, v, cos2, sin2, causal, scale):
    """``fn(q, k, v, cos2, sin2, causal, scale) -> O`` at the padded head
    dim: q, k, v padded half by half and the ``[S, D/2]`` tables with
    zero columns (a zero pair rotates to zero and adds nothing to the
    scores), O's two halves sliced back. ``scale`` is the true head
    dim's."""
    d = int(q.shape[-1])
    dp = padded_head_dim(d)
    if dp == d:
        return fn(q, k, v, cos2, sin2, causal, scale)
    h2, hp = d // 2, dp // 2
    o = fn(*(pad_halves(t, hp) for t in (q, k, v)),
           *(torch.nn.functional.pad(t, (0, hp - h2)) for t in (cos2, sin2)),
           causal, scale)
    return unpad_halves(o, h2)


def rope_attention_cuda(q, k, v, cos, sin, causal=True, scale=None,
                        cuda_cores=False):
    """Launch ``ptt_rope_attention_fwd`` of ``csrc/flash_attention.cu``:
    the design :func:`design` gives (``cuda_cores``: the CUDA-core
    kernel, to compare with); raises on anything it does not take."""
    global launches, fp16_launches
    cos2, sin2 = _check(q, k, v, cos, sin)
    d = int(q.shape[3])
    _check_cuda(q, k, v, cos2, sin2)
    check_head_dim(d, "rope attention kernel")
    o = padded_rope_attention(
        functools.partial(_launch, cuda_cores=cuda_cores), q, k, v, cos2,
        sin2, bool(causal), _scale_of(q, scale))
    launches += 1
    fp16_launches += q.dtype == torch.float16
    kind = "cc" if cuda_cores else design(q.dtype, d)
    globals()[f"{kind}_launches"] += 1
    return o


def _check_cuda(q, k, v, cos2, sin2):
    """The kernel's checks of its inputs' devices and dtypes."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"rope attention kernel needs CUDA tensors, got "
                         f"{dev}")
    for name, t in (("k", k), ("v", v), ("cos", cos2), ("sin", sin2)):
        if t.device != dev:
            raise ValueError(f"rope attention: {name} on {t.device}, q on "
                             f"{dev}")
    if q.dtype not in _build.FLOAT_TYPES \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"rope attention kernel takes q, k, v of one dtype, "
                        f"float32, bfloat16 or float16, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if cos2.dtype != torch.float32 or sin2.dtype != torch.float32:
        raise TypeError(f"rope attention kernel takes float32 tables, got "
                        f"{cos2.dtype} and {sin2.dtype}")


def _launch(q, k, v, cos2, sin2, causal, scale, cuda_cores=False):
    """The launch at a head dim that is a multiple of 16."""
    b, s, h, d = (int(x) for x in q.shape)
    tab = int(cos2.stride(0))
    if cos2.stride(1) != 1 or sin2.stride(1) != 1 \
            or int(sin2.stride(0)) != tab or tab % 4 \
            or cos2.data_ptr() % 16 or sin2.data_ptr() % 16:
        raise ValueError(
            f"rope attention reads the tables in 16-byte vectors: rows of "
            f"unit stride, one row stride for both that is a multiple of "
            f"4, 16-byte aligned; got strides {tuple(cos2.stride())} and "
            f"{tuple(sin2.stride())}")
    vec = 16 // q.element_size()
    st = [_strides(t, n, vec) for n, t in (("q", q), ("k", k), ("v", v))]
    lib = _build.load()
    o = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    # the split design: the rotated q and k and v in three parts, laid
    # out as flash attention's split forward reads them
    work = None
    if not cuda_cores and design(q.dtype, d) == "split":
        work = torch.empty(split_workspace_elems(b, s, s, h, d, 1, 2),
                           dtype=torch.bfloat16, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.ptt_rope_attention_fwd(
            _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(o),
            _build.ptr(cos2), _build.ptr(sin2), tab, b, h, s, d, *st[0],
            *st[1], *st[2], int(causal), scale,
            _build.DTYPE_CODES[q.dtype],
            None if work is None else _build.ptr(work), int(cuda_cores),
            _build.stream_of(q),
        )
    _build.check(err, "ptt_rope_attention_fwd")
    return o
