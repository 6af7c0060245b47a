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
version on a CPU tensor. Its backward is autograd through the plain
version, recomputed from the saved inputs: that is the JAX package's own
design (the ``custom_vjp``'s ``_bwd`` is the VJP of
``_composed_2d_tables``), not a fallback, so there is no backward kernel.
The tables get no gradient.

In the port this kernel runs where the model selects the fusion
(``LlamaForCausalLM(fusions={"rope_attention"})``): the JAX package
selects its TPU kernel through the tune cache
(``rope_attention_select``), which is not ported. The TPU kernel's
``S % block_q`` restriction is a tiling artefact and is not ported: the
kernel takes any S and masks the ragged tail.
"""
from __future__ import annotations

import math

import torch

from . import _build
from .flash_attention import check_head_dim

launches = 0


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


def rope_attention_reference(q, k, v, cos, sin, causal=True, scale=None):
    """Plain PyTorch version, in ``_composed_2d_tables``' order:
    everything fp32, rotate, scores, exact softmax, ``P @ V``, one
    cast. Returns ``[B, S, H, D]`` in q's dtype."""
    cos2, sin2 = _check(q, k, v, cos, sin)
    return _composed(q, k, v, cos2, sin2, bool(causal), _scale_of(q, scale))


class _RopeAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, cos2, sin2, causal, scale):
        if q.device.type == "cpu":
            out = _composed(q, k, v, cos2, sin2, causal, scale)
        else:
            out = rope_attention_cuda(q, k, v, cos2, sin2, causal, scale)
        ctx.save_for_backward(q, k, v, cos2, sin2)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, g):
        # the VJP of the plain version, as the JAX _bwd takes the VJP of
        # _composed_2d_tables: recomputed from the saved inputs
        q, k, v, cos2, sin2 = ctx.saved_tensors
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = _composed(*ins, cos2, sin2, ctx.causal, ctx.scale)
            dq, dk, dv = torch.autograd.grad(out, ins, g)
        return dq, dk, dv, None, None, None, None


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


def rope_attention_cuda(q, k, v, cos, sin, causal=True, scale=None):
    """Launch ``ptt_rope_attention_fwd`` of ``csrc/flash_attention.cu``;
    raises on anything it does not take."""
    global launches
    cos2, sin2 = _check(q, k, v, cos, sin)
    b, s, h, d = (int(x) for x in q.shape)
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"rope attention kernel needs CUDA tensors, got "
                         f"{dev}")
    for name, t in (("k", k), ("v", v), ("cos", cos2), ("sin", sin2)):
        if t.device != dev:
            raise ValueError(f"rope attention: {name} on {t.device}, q on "
                             f"{dev}")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"rope attention kernel takes q, k, v of one dtype, "
                        f"float32 or bfloat16, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if cos2.dtype != torch.float32 or sin2.dtype != torch.float32:
        raise TypeError(f"rope attention kernel takes float32 tables, got "
                        f"{cos2.dtype} and {sin2.dtype}")
    check_head_dim(d, "rope attention kernel")
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
    o = torch.empty((b, s, h, d), dtype=q.dtype, device=dev)
    with torch.cuda.device(dev):
        err = lib.ptt_rope_attention_fwd(
            _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(o),
            _build.ptr(cos2), _build.ptr(sin2), tab, b, h, s, d, *st[0],
            *st[1], *st[2], int(bool(causal)), _scale_of(q, scale),
            _build.DTYPE_CODES[q.dtype], _build.stream_of(q),
        )
    _build.check(err, "ptt_rope_attention_fwd")
    launches += 1
    return o
