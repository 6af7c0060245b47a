"""RMSNorm forward and backward: the hand-written Hopper kernels and their
plain versions.

Counterpart of ``paddle_tpu/kernels/rms_norm.py`` (``rms_norm_fused``, a
``jax.custom_vjp``; the TPU kernels are ``_fwd_kernel``, launched from
``_rms_fwd``, and ``_bwd_kernel``, launched from ``_rms_bwd``). The CUDA
source is ``paddle_tpu_torch/csrc/rms_norm.cu``; its header says what
bounds it on the H100 and how the design answers that.

:func:`rms_norm` is a ``torch.autograd.Function`` that routes on the
tensor's device in both directions: a CPU tensor goes to
:func:`rms_norm_reference` and :func:`rms_norm_backward_reference`, a
CUDA tensor to the kernels, which either launch or raise. The forward
keeps the fp32 ``rstd`` (one per row) for the backward, as the TPU
kernel does; the backward never recomputes it.
"""
from __future__ import annotations

import torch

from ..amp import naninf as _naninf
from . import _build

# kernel launches made by this process (CUDA tensors through rms_norm):
# the forward kernel and the backward kernels (one per backward call)
launches = 0
bwd_launches = 0
# of those, the launches over fp16 tensors
fp16_launches = 0
fp16_bwd_launches = 0

# CTAs of the backward's first pass: each owns a fixed run of rows and
# writes its fp32 dw column sums; the second pass adds them in CTA order
BWD_CTAS = 256


def rms_norm_reference(x, w, eps=1e-6, return_rstd=False):
    """Plain PyTorch RMSNorm in the TPU kernel's op order: fp32 mean of
    squares, rsqrt, scale, multiply by ``w`` in fp32, ONE cast to x's
    type (``rms_norm.py:35-38``). With ``return_rstd`` also the fp32
    ``rstd`` ``[...]`` (x's shape without the last axis)."""
    xf = x.float()
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(ms + eps)
    y = ((xf * rstd) * w.float()).to(x.dtype)
    return (y, rstd[..., 0]) if return_rstd else y


def rms_norm_backward_reference(x, w, g, rstd):
    """Plain PyTorch backward in the op order of ``_bwd_kernel``
    (``rms_norm.py:68-79``) and ``_vjp_bwd`` (``:133-136``): ``g`` is
    cast to x's type first; in fp32, ``dx = rstd*g*w - x*rstd^3 *
    mean(g*w*x)`` cast once to x's type, and ``dw = sum over rows of g *
    (x * rstd)`` cast once to w's type."""
    h = int(x.shape[-1])
    xf = x.reshape(-1, h).float()
    gf = g.reshape(-1, h).to(x.dtype).float()
    wf = w.float()
    r = rstd.reshape(-1, 1).float()
    gw = gf * wf
    m = (gw * xf).mean(dim=-1, keepdim=True)
    dx = r * gw - xf * (r * r * r) * m
    dw = (gf * (xf * r)).sum(dim=0)
    return dx.to(x.dtype).reshape(x.shape), dw.to(w.dtype)


def _forward(x, w, eps):
    if x.device.type == "cpu":
        return rms_norm_reference(x, w, eps, return_rstd=True)
    return rms_norm_cuda(x, w, eps, return_rstd=True)


def _backward(x, w, g, rstd):
    if x.device.type == "cpu":
        return rms_norm_backward_reference(x, w, g, rstd)
    return rms_norm_backward_cuda(x, w, g, rstd)


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, eps):
        y, rstd = _naninf.kernel_op("fused_rms_norm", _forward, x, w, eps)
        ctx.save_for_backward(x, w, rstd)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, rstd = ctx.saved_tensors
        dx, dw = _naninf.kernel_op("fused_rms_norm", _backward, x, w, g,
                                   rstd)
        return dx, dw, None


def rms_norm(x, w, eps=1e-6):
    """``x`` [..., H] fp32/bf16/fp16, ``w`` [H] -> normalised ``x * w`` in
    x's dtype; differentiable in x and w."""
    return _RMSNorm.apply(x, w, float(eps))


def _check(x, w, name):
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(
            f"{name} kernel needs x and w on one CUDA device, got "
            f"{x.device} and {w.device}"
        )
    if x.dtype not in _build.FLOAT_TYPES or w.dtype != x.dtype:
        raise TypeError(
            f"{name} kernel takes float32/bfloat16/float16 x and w of one "
            f"dtype, got x {x.dtype}, w {w.dtype}"
        )
    h = int(x.shape[-1])
    vec = 16 // x.element_size()
    if tuple(w.shape) != (h,):
        raise ValueError(f"w must be [{h}], got {tuple(w.shape)}")
    if h % vec:
        raise ValueError(
            f"{name} kernel needs the hidden size to be a multiple of "
            f"{vec} for {x.dtype}, got {h}"
        )
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{name} kernel needs contiguous x and w")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError(f"{name} kernel needs 16-byte aligned x and w")
    return h


def rms_norm_cuda(x, w, eps=1e-6, return_rstd=False):
    """Launch the forward of ``csrc/rms_norm.cu``; raises on anything it
    does not take. With ``return_rstd`` also the fp32 rstd per row."""
    global launches, fp16_launches
    h = _check(x, w, "rms_norm")
    lib = _build.load()
    y = torch.empty_like(x)
    rows = x.numel() // h if h else 0
    rstd = (torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
            if return_rstd else None)
    with torch.cuda.device(x.device):
        err = lib.ptt_rms_norm_fwd(
            _build.ptr(x), _build.ptr(w), _build.ptr(y),
            None if rstd is None else _build.ptr(rstd), rows, h,
            _build.DTYPE_CODES[x.dtype], float(eps), _build.stream_of(x),
        )
    _build.check(err, "ptt_rms_norm_fwd")
    launches += 1
    fp16_launches += x.dtype == torch.float16
    return (y, rstd) if return_rstd else y


def rms_norm_backward_cuda(x, w, g, rstd):
    """Launch the backward of ``csrc/rms_norm.cu``: ``(dx, dw)`` with dx
    in x's type and dw in w's type."""
    global bwd_launches, fp16_bwd_launches
    h = _check(x, w, "rms_norm backward")
    # the incoming gradient in x's type, as _vjp_bwd casts it
    g = g.to(x.dtype).contiguous()
    if g.shape != x.shape or g.device != x.device:
        raise ValueError(f"g must be {tuple(x.shape)} on {x.device}, got "
                         f"{tuple(g.shape)} on {g.device}")
    rows = x.numel() // h
    if rstd.dtype != torch.float32 or rstd.numel() != rows \
            or not rstd.is_contiguous():
        raise ValueError("rstd must be the forward's contiguous fp32 "
                         f"[{rows}] rows")
    if h > 2 * 1024 * (16 // x.element_size()):
        raise ValueError(
            f"rms_norm backward keeps two vectors per thread: hidden {h} "
            f"is above {2 * 1024 * (16 // x.element_size())} for {x.dtype}"
        )
    lib = _build.load()
    dx = torch.empty_like(x)
    dw = torch.empty_like(w)
    if rows == 0:
        dw.zero_()
        return dx, dw
    ctas = min(rows, BWD_CTAS)
    partials = torch.empty((ctas, h), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.ptt_rms_norm_bwd(
            _build.ptr(x), _build.ptr(w), _build.ptr(g), _build.ptr(rstd),
            _build.ptr(dx), _build.ptr(dw), _build.ptr(partials), rows, h,
            ctas, _build.DTYPE_CODES[x.dtype], _build.stream_of(x),
        )
    _build.check(err, "ptt_rms_norm_bwd")
    bwd_launches += 1
    fp16_bwd_launches += x.dtype == torch.float16
    return dx, dw
