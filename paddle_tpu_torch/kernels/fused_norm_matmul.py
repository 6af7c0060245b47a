"""Fused RMSNorm + matmul (the norm + lm_head of the Llama head): the
hand-written Hopper kernel and its plain version.

Counterpart of ``paddle_tpu/kernels/fused_norm_matmul.py``
(``rms_norm_matmul``, a ``jax.custom_vjp`` over ``_norm_matmul``, whose
TPU kernel is ``_fused_kernel``; ``rms_norm_matmul_composed`` and
``_composed_2d`` for the plain version). The CUDA source is
``paddle_tpu_torch/csrc/fused_norm_matmul.cu``; its header says what
bounds it on the H100 and how the design answers that.

The function: ``rms_norm(x, w) @ wm`` with x ``[..., H]``, w ``[H]`` and
wm ``[H, N]``. The norm is fp32, multiplied by ``w`` in fp32 and rounded
ONCE to x's dtype before the product (``_normed_rows``); the product
sums in fp32 and is cast once to ``promote(x, wm)``.

:func:`rms_norm_matmul` is a ``torch.autograd.Function``. Its forward
runs the kernel on a CUDA tensor (or raises) and the plain version on a
CPU tensor. Its backward is autograd through the plain version,
recomputed from the saved inputs: that is the JAX package's own design
(the ``custom_vjp``'s ``_bwd`` is the VJP of ``_composed_2d``), not a
fallback, so there is no backward kernel.

In the port this kernel runs where the model selects the fusion
(``LlamaForCausalLM(fusions={"rms_norm_matmul"})``): the JAX package
selects its TPU kernel through the tune cache (``head_fusion_select``),
which is not ported.

Three designs, chosen by x's dtype and row count (:func:`design`):
bf16 runs the tensor-core kernels (``"tc"``, ``ptt_rms_norm_matmul_tc``:
an rstd pre-pass, then wgmma on the normed tile built in shared memory;
the swap-AB kernel up to :data:`SWAP_MAX_ROWS` rows, split over K
chunks, the tiled kernel above). fp32 from :data:`SPLIT_MIN_ROWS` rows
runs the split design (``"split"``, ``ptt_rms_norm_matmul_split``): the
tensor cores take fp32 only as TF32, so the normed rows and the weight
are each split into three bf16 parts (hi, mid, lo: all 24 bits) by
pre-passes into a bf16 workspace, and every product is six bf16
products of parts, smallest first, with fp32 accumulators; nothing is
rounded, as in fp32 the normed row is not. fp32 below that runs the
CUDA-core kernels (``"cc"``, ``ptt_rms_norm_matmul``): there the weight
read bounds the call, and splitting it would add 1.5 times its bytes.
``cuda_cores=True`` runs the CUDA-core kernels at any fp32 row count
(the design the split one replaced, kept to compare with).
``tc_launches``, ``split_launches`` and ``cc_launches`` count each
design beside ``launches``.
"""
from __future__ import annotations

import torch

from ..amp import naninf as _naninf
from . import _build
from .int8_matmul import SWAP_TILES, TC_KTILE, swap_kchunk

# one per call (the pre-passes and the split-K sum are part of it), and
# the same by design: tensor cores (bf16), split products on the tensor
# cores (fp32 from SPLIT_MIN_ROWS rows), CUDA cores (fp32 below)
launches = 0
tc_launches = 0
split_launches = 0
cc_launches = 0
DESIGN_COUNTERS = ("tc_launches", "split_launches", "cc_launches")

X_DTYPES = (torch.float32, torch.bfloat16)
K_CHUNK = 512  # K rows per CTA of the narrow (rows <= 16) CUDA-core kernel
NARROW_ROWS = 16
VEC = 8  # elements of the kernels' vectors: H and N are multiples
# rows up to which the tensor-core design runs the swap-AB kernel: the
# crossover with the tiled kernel, measured by chip_smoke.py's sweep at
# the Llama head (the swap-AB kernel is faster up to 64 rows, the tiled
# one from 128)
SWAP_MAX_ROWS = 64
# CTAs per SM the swap-AB kernel's K split aims at: one is enough to fill
# the card with the lm_head's 250 column tiles, and spares the second
# kernel that sums the chunks
SWAP_CTAS_PER_SM = 1
# fp32 rows from which the split design runs: the crossover with the
# CUDA-core kernels, measured by chip_smoke.py's fp32 sweep at the Llama
# head. Up to NARROW_ROWS the narrow kernel is bound by the weight read
# and beats the split design, whose pre-pass writes 1.5 times the
# weight's bytes more; above, the wide kernel costs a whole 128-row tile
# and the split design wins at every row count swept
SPLIT_MIN_ROWS = NARROW_ROWS + 1
# the workspace's normed rows are padded to a multiple of this (the row
# pitch of its tensor map must be a multiple of 16 bytes)
SPLIT_ROW_ALIGN = 8


def design(dtype, rows):
    """``"tc"`` (tensor cores, bf16 x), ``"split"`` (split products on the
    tensor cores, fp32 x of at least :data:`SPLIT_MIN_ROWS` rows) or
    ``"cc"`` (CUDA cores, fp32 x of fewer rows)."""
    if dtype == torch.bfloat16:
        return "tc"
    return "split" if rows >= SPLIT_MIN_ROWS else "cc"


def _scaled_rows(x2d, w, eps):
    """fp32 RMSNorm of ``[rows, H]`` times ``w`` in fp32, before the
    rounding (``fused_norm_matmul.py:35-41``)."""
    xf = x2d.float()
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(ms + eps)
    return (xf * rstd) * w.float()


def _normed_rows(x2d, w, eps):
    """The normed rows rounded to x's dtype (``:42``)."""
    return _scaled_rows(x2d, w, eps).to(x2d.dtype)


def rms_norm_matmul_reference(x, w, wm, eps=1e-6):
    """Plain PyTorch version in ``_composed_2d``'s op order: the rounded
    norm, then the product summed in fp32 and cast once to
    ``promote(x, wm)``."""
    h = int(x.shape[-1])
    n = int(wm.shape[1])
    y = _normed_rows(x.reshape(-1, h), w.reshape(1, h), float(eps))
    out_dtype = torch.promote_types(x.dtype, wm.dtype)
    out = torch.matmul(y.float(), wm.float()).to(out_dtype)
    return out.reshape(tuple(x.shape[:-1]) + (n,))


def normed_rounding_slack(x, w, wm, eps=1e-6, rel=2.0 ** -20):
    """Per-output bound on how far the rounding of the normed row may
    move the product when two implementations' rstd differ by less than
    ``rel`` (relative: the sum of squares is reduced in another order).
    An entry of ``(x * rstd) * w`` within ``rel`` of a rounding midpoint
    of x's dtype may round to either neighbour, one ulp apart, so output
    ``(r, n)`` may move by the sum over such ``k`` of ``ulp(y_rk) *
    |wm_kn|`` before its cast. Zero for fp32 x, where nothing is rounded
    before the product. Used to hold the kernel against the plain
    version."""
    h = int(x.shape[-1])
    n = int(wm.shape[1])
    shape = tuple(x.shape[:-1]) + (n,)
    if x.dtype == torch.float32:
        return torch.zeros(shape, dtype=torch.float32, device=x.device)
    v = _scaled_rows(x.reshape(-1, h), w.reshape(1, h), float(eps))
    b = v.to(x.dtype).float()
    # |v| in [2^(e-1), 2^e): one ulp is eps * 2^(e-1)
    _, e = torch.frexp(torch.maximum(v.abs(), b.abs()))
    ulp = torch.ldexp(torch.full_like(v, torch.finfo(x.dtype).eps), e - 1)
    near = ulp / 2 - (v - b).abs() <= rel * v.abs()
    slack = torch.matmul(torch.where(near, ulp, torch.zeros_like(ulp)),
                         wm.float().abs())
    return slack.reshape(shape)


def _forward(x, w, wm, eps):
    if x.device.type == "cpu":
        return rms_norm_matmul_reference(x, w, wm, eps)
    return rms_norm_matmul_cuda(x, w, wm, eps)


def _vjp(x, w, wm, eps, g):
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (x, w, wm)]
        out = rms_norm_matmul_reference(*ins, eps)
        return torch.autograd.grad(out, ins, g)


class _RmsNormMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, wm, eps):
        out = _naninf.kernel_op("rms_norm_matmul", _forward, x, w, wm, eps)
        ctx.save_for_backward(x, w, wm)
        ctx.eps = eps
        return out

    @staticmethod
    def backward(ctx, g):
        # the VJP of the plain version, as the JAX _bwd takes the VJP of
        # _composed_2d: recomputed from the saved inputs
        x, w, wm = ctx.saved_tensors
        dx, dw, dwm = _naninf.kernel_op("rms_norm_matmul", _vjp, x, w, wm,
                                        ctx.eps, g)
        return dx, dw, dwm, None


def rms_norm_matmul(x, w, wm, eps=1e-6):
    """``rms_norm(x, w) @ wm``; differentiable in all three. Routes on
    x's device (CPU: the plain version; CUDA: the kernel, or a raise)."""
    return _RmsNormMatmul.apply(x, w, wm, float(eps))


def rms_norm_matmul_cuda(x, w, wm, eps=1e-6, cuda_cores=False):
    """Launch ``csrc/fused_norm_matmul.cu``: the design :func:`design`
    gives for x's dtype and row count (bf16: the swap-AB kernel up to
    :data:`SWAP_MAX_ROWS` rows, the tiled one above; ``cuda_cores``: the
    fp32 CUDA-core kernels at any row count, to compare with); raises on
    anything it does not take."""
    x2, h, n = _checked(x, w, wm)
    rows = int(x2.shape[0])
    if cuda_cores:
        if x.dtype != torch.float32:
            raise ValueError(f"rms_norm_matmul: the CUDA-core kernels take "
                             f"float32 x, got {x.dtype}")
        kind = "cc"
    else:
        kind = design(x.dtype, rows)
    if kind == "tc":
        out = _tc_kernel(x2, w, wm, eps,
                         "swap" if rows <= SWAP_MAX_ROWS else "tiled")
    elif kind == "split":
        out = _split_kernel(x2, w, wm, eps)
    else:
        out = _cc_kernel(x2, w, wm, eps)
    return out.reshape(tuple(x.shape[:-1]) + (n,))


def _cc_kernel(x2, w, wm, eps):
    """The fp32 CUDA-core kernels on checked x2 ``[rows, H]`` (narrow up
    to :data:`NARROW_ROWS` rows, split over K chunks; wide above)."""
    global launches, cc_launches
    rows, h = (int(v) for v in x2.shape)
    n = int(wm.shape[1])
    dev = x2.device
    out = torch.empty((rows, n), dtype=x2.dtype, device=dev)
    chunks = -(-h // K_CHUNK)
    partial = None
    if rows <= NARROW_ROWS and chunks > 1:
        partial = torch.empty((chunks, rows, n), dtype=torch.float32,
                              device=dev)
    with torch.cuda.device(dev):
        err = _build.load().ptt_rms_norm_matmul(
            _build.ptr(x2), _build.ptr(w), _build.ptr(wm), _build.ptr(out),
            None if partial is None else _build.ptr(partial),
            rows, h, n, K_CHUNK, float(eps), _build.stream_of(x2),
        )
    _build.check(err, "ptt_rms_norm_matmul")
    cc_launches += 1
    launches += 1
    return out


def split_workspace_elems(rows, h, n):
    """bf16 values of the split design's workspace: the three parts of
    the normed rows (``[3, H, rows]``, rows padded to a multiple of
    :data:`SPLIT_ROW_ALIGN`) and of the weight (``[3, H, N]``)."""
    r8 = -(-rows // SPLIT_ROW_ALIGN) * SPLIT_ROW_ALIGN
    return 3 * h * (r8 + n)


def _split_kernel(x2, w, wm, eps):
    """The fp32 split design on checked x2 ``[rows, H]``: the out ``[rows,
    N]``. :func:`rms_norm_matmul_cuda` picks it from
    :data:`SPLIT_MIN_ROWS` rows; ``chip_smoke.py``'s crossover sweep runs
    it at every row count."""
    global launches, split_launches
    rows, h = (int(v) for v in x2.shape)
    n = int(wm.shape[1])
    if x2.dtype != torch.float32 or w.dtype != torch.float32:
        raise ValueError(f"rms_norm_matmul: the split design takes float32 "
                         f"x and w, got {x2.dtype} and {w.dtype}")
    dev = x2.device
    out = torch.empty((rows, n), dtype=torch.float32, device=dev)
    rstd = torch.empty((rows,), dtype=torch.float32, device=dev)
    work = torch.empty((split_workspace_elems(rows, h, n),),
                       dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        err = _build.load().ptt_rms_norm_matmul_split(
            _build.ptr(x2), _build.ptr(w), _build.ptr(wm), _build.ptr(out),
            _build.ptr(rstd), _build.ptr(work), rows, h, n, float(eps),
            _build.stream_of(x2),
        )
    _build.check(err, "ptt_rms_norm_matmul_split")
    split_launches += 1
    launches += 1
    return out


def _checked(x, w, wm):
    """The kernels' checks of their inputs: (x as ``[rows, H]``, H, N)."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"rms_norm_matmul kernel needs CUDA tensors, got "
                         f"{dev}")
    for name, t in (("w", w), ("wm", wm)):
        if t.device != dev:
            raise ValueError(f"rms_norm_matmul: {name} on {t.device}, x on "
                             f"{dev}")
    if torch.float16 in (x.dtype, w.dtype, wm.dtype):
        raise _build.fp16_refused("the fused RMSNorm + matmul", 1)
    if x.dtype not in X_DTYPES or wm.dtype != x.dtype \
            or w.dtype not in (x.dtype, torch.float32):
        raise TypeError(
            f"rms_norm_matmul kernel takes x and wm of one dtype (float32 "
            f"or bfloat16) and w in x's dtype or float32, got x {x.dtype}, "
            f"w {w.dtype}, wm {wm.dtype}")
    h = int(x.shape[-1])
    if wm.dim() != 2 or int(wm.shape[0]) != h or tuple(w.shape) != (h,):
        raise ValueError(f"rms_norm_matmul: x [..., H], w [H], wm [H, N]; "
                         f"got x {tuple(x.shape)}, w {tuple(w.shape)}, wm "
                         f"{tuple(wm.shape)}")
    n = int(wm.shape[1])
    if h % VEC or n % VEC:
        raise ValueError(f"rms_norm_matmul kernel reads {VEC}-element "
                         f"vectors: H and N must be multiples of {VEC}, got "
                         f"x {tuple(x.shape)}, wm {tuple(wm.shape)}")
    if not (w.is_contiguous() and wm.is_contiguous()):
        raise ValueError("rms_norm_matmul kernel needs contiguous w and wm")
    x2 = x.reshape(-1, h).contiguous()
    if any(t.data_ptr() % 16 for t in (x2, w, wm)):
        raise ValueError("rms_norm_matmul kernel needs 16-byte aligned x, "
                         "w and wm")
    return x2, h, n


def _tc_kernel(x2, w, wm, eps, kernel):
    """One tensor-core kernel, "swap" or "tiled" (each after the rstd
    pre-pass), on checked bf16 x2 ``[rows, H]``: the out ``[rows, N]``.
    :func:`rms_norm_matmul_cuda` picks the kernel; ``chip_smoke.py``'s
    crossover sweep names each one."""
    global launches, tc_launches
    rows, h = (int(v) for v in x2.shape)
    n = int(wm.shape[1])
    if x2.dtype != torch.bfloat16 or kernel not in ("swap", "tiled") or (
            kernel == "swap" and rows > SWAP_TILES[-1]):
        raise ValueError(f"rms_norm_matmul: no {kernel!r} kernel for "
                         f"{x2.dtype} x of {rows} rows")
    dev = x2.device
    out = torch.empty((rows, n), dtype=x2.dtype, device=dev)
    rstd = torch.empty((rows,), dtype=torch.float32, device=dev)
    swap_rows, kchunk, partial = 0, TC_KTILE, None
    if kernel == "swap":
        swap_rows = next(t for t in SWAP_TILES if t >= rows)
        kchunk = swap_kchunk(h, n, _build.sm_count(dev), SWAP_CTAS_PER_SM)
        chunks = -(-h // kchunk)
        if chunks > 1:
            partial = torch.empty((chunks, rows, n), dtype=torch.float32,
                                  device=dev)
    with torch.cuda.device(dev):
        err = _build.load().ptt_rms_norm_matmul_tc(
            _build.ptr(x2), _build.ptr(w), _build.ptr(wm), _build.ptr(out),
            _build.ptr(rstd),
            None if partial is None else _build.ptr(partial),
            rows, h, n, kchunk, swap_rows, _build.DTYPE_CODES[w.dtype],
            float(eps), _build.stream_of(x2),
        )
    _build.check(err, "ptt_rms_norm_matmul_tc")
    tc_launches += 1
    launches += 1
    return out
