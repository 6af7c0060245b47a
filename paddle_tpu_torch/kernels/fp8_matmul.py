"""fp8 GEMM and fp8 quantization (AMP O3): the hand-written Hopper
kernels, their plain versions, and the launch counts.

Counterpart of what ``paddle_tpu/amp/fp8.py`` leaves to XLA: the
``dot_general`` on fp8 operands with fp32 accumulation of ``_fp8_dot``
(``:135-139``, ``:145-149``, ``:160-168``) and ``_quantize`` (``:117``)
with the amaxes it takes beside it (``:157``, ``:195-202``). No Pallas
kernel is replaced. The CUDA source is ``paddle_tpu_torch/csrc/
fp8_matmul.cu``.

- :func:`gemm` ``(a, bt, sa, sb, out_dtype)``: ``out[M, N] = (a[M, K] .
  bt[N, K]^T) * (sa * sb)``, summed in fp32 and rounded once to
  ``out_dtype`` (fp32, bf16 or fp16). Both operands are fp8 codes with
  their contraction axis contiguous (the only layout ``wgmma`` reads for
  8-bit types); ``sa`` and ``sb`` are fp32 device scalars.
- :func:`quantize` ``(x, scale, fmt, rows, transposed, amax)``: the codes
  of ``clip(float(x) / scale, +-fmax)`` in ``fmt`` ("e4m3" or "e5m2"),
  rounded to nearest even, as ``x``'s layout (``rows``) and/or
  transposed, and ``amax(|x|)`` as a device scalar; with neither layout
  only the amax (the backward's just-in-time scale).

On a CUDA tensor each launches its kernel or raises; on the CPU each is
its plain version, which is also what the kernels are held against on
the card. ``launches`` counts GEMM launches, ``quantize_launches``
quantize launches; each call is one op of the NaN/Inf sweep
(``fp8_gemm``, ``fp8_quantize``).
"""
from __future__ import annotations

import torch

from ..amp import naninf as _naninf
from . import _build

launches = 0
quantize_launches = 0

FORMATS = {"e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2}
FMAX = {"e4m3": 448.0, "e5m2": 57344.0}
FORMAT_CODES = {"e4m3": 0, "e5m2": 1}
OUT_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
# the contraction axis is padded with zero columns to a multiple of this
# many codes for the kernel (TMA's 16-byte row stride)
K_ALIGN = 16


def _format_of(t):
    for name, dtype in FORMATS.items():
        if t.dtype == dtype:
            return name
    raise TypeError(f"fp8 operand must be float8_e4m3fn or float8_e5m2, "
                    f"got {t.dtype}")


# ------------------------------------------------------------ the plain versions
def quantize_reference(x, scale, fmt, rows=True, transposed=False,
                       amax=False):
    """``(q, q^T, amax)``, each None unless asked for: ``torch.clamp(
    x.float() / scale, -fmax, fmax).to(fp8)`` (the cast rounds to nearest
    even) and ``max |x|`` in fp32."""
    q = qt = am = None
    if rows or transposed:
        codes = torch.clamp(x.float() / scale, -FMAX[fmt],
                            FMAX[fmt]).to(FORMATS[fmt])
        q = codes if rows else None
        qt = codes.t().contiguous() if transposed else None
    if amax:
        am = (x.float().abs().amax() if x.numel()
              else torch.zeros((), dtype=torch.float32, device=x.device))
    return q, qt, am


def gemm_reference(a, bt, sa, sb, out_dtype):
    """``(a.float() @ bt.float().T) * (sa * sb)`` in fp32, then rounded
    to ``out_dtype``: every fp8 x fp8 product is exact in fp32."""
    out = torch.matmul(a.float(), bt.float().t()) * (sa * sb)
    return out.to(out_dtype)


# ----------------------------------------------------------------- the functions
def quantize(x, scale, fmt, rows=True, transposed=False, amax=False):
    """The codes of ``x`` (2-D) in ``fmt``: ``(q, q^T, amax)`` as asked;
    routes on x's device (CPU: the plain version; CUDA: the kernel, or a
    raise)."""
    return _naninf.kernel_op("fp8_quantize", _route_quantize, x, scale, fmt,
                             rows, transposed, amax)


def _route_quantize(x, scale, fmt, rows, transposed, amax):
    if x.device.type == "cpu":
        return quantize_reference(x, scale, fmt, rows, transposed, amax)
    return quantize_cuda(x, scale, fmt, rows, transposed, amax)


def gemm(a, bt, sa, sb, out_dtype):
    """``(a . bt^T) * (sa * sb)`` as ``out_dtype``; routes on a's device."""
    return _naninf.kernel_op("fp8_gemm", _route_gemm, a, bt, sa, sb,
                             out_dtype)


def _route_gemm(a, bt, sa, sb, out_dtype):
    if a.device.type == "cpu":
        return gemm_reference(a, bt, sa, sb, out_dtype)
    return gemm_cuda(a, bt, sa, sb, out_dtype)


# ----------------------------------------------------------------- the kernels
def _scalar(t, dev, name):
    if not isinstance(t, torch.Tensor) or t.numel() != 1 \
            or t.dtype != torch.float32 or t.device != dev:
        raise TypeError(f"fp8 kernels: {name} must be one fp32 value on "
                        f"{dev}, got {t!r}")
    return t.contiguous()


def quantize_cuda(x, scale, fmt, rows=True, transposed=False, amax=False):
    """Launch ``ptt_fp8_quantize`` on 2-D ``x`` (fp32, bf16 or fp16)."""
    global quantize_launches
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"fp8 quantize kernel needs a CUDA tensor, got {dev}")
    if x.dim() != 2 or x.dtype not in _build.FLOAT_TYPES:
        raise TypeError(f"fp8 quantize kernel takes a 2-D fp32, bf16 or "
                        f"fp16 tensor, got {x.dtype} {tuple(x.shape)}")
    if fmt not in FORMATS:
        raise ValueError(f"fp8 format must be e4m3 or e5m2, got {fmt!r}")
    if not (rows or transposed or amax):
        raise ValueError("fp8 quantize: nothing asked for")
    x = x.contiguous()
    n_rows, n_cols = (int(v) for v in x.shape)
    q = (torch.empty((n_rows, n_cols), dtype=FORMATS[fmt], device=dev)
         if rows else None)
    qt = (torch.empty((n_cols, n_rows), dtype=FORMATS[fmt], device=dev)
          if transposed else None)
    am = torch.zeros((), dtype=torch.float32, device=dev) if amax else None
    s = _scalar(scale, dev, "scale") if (rows or transposed) else None
    with torch.cuda.device(dev):
        err = _build.load().ptt_fp8_quantize(
            _build.ptr(x), None if q is None else _build.ptr(q),
            None if qt is None else _build.ptr(qt),
            None if am is None else _build.ptr(am),
            None if s is None else _build.ptr(s), n_rows, n_cols,
            _build.DTYPE_CODES[x.dtype], FORMAT_CODES[fmt],
            _build.stream_of(x))
    _build.check(err, "ptt_fp8_quantize")
    quantize_launches += 1
    return q, qt, am


def _kernel_operand(t):
    """``t`` as the kernel reads it: contiguous, 16-byte aligned, its row
    length a multiple of :data:`K_ALIGN` (zero columns appended: they add
    nothing to the sums)."""
    rows, k = (int(v) for v in t.shape)
    if t.is_contiguous() and k % K_ALIGN == 0 and t.data_ptr() % 16 == 0:
        return t
    kp = -(-k // K_ALIGN) * K_ALIGN
    out = torch.zeros((rows, kp), dtype=torch.uint8, device=t.device)
    out[:, :k].copy_(t.view(torch.uint8) if t.is_contiguous()
                     else t.contiguous().view(torch.uint8))
    return out.view(t.dtype)


def gemm_cuda(a, bt, sa, sb, out_dtype):
    """Launch ``ptt_fp8_gemm``: ``a [M, K]`` and ``bt [N, K]`` fp8 (one
    of the step's three forms: e4m3 . e4m3, e5m2 . e4m3, e4m3 . e5m2)."""
    global launches
    dev = a.device
    if dev.type != "cuda" or bt.device != dev:
        raise ValueError(f"fp8 gemm kernel needs CUDA tensors on one "
                         f"device, got {a.device} and {bt.device}")
    fa, fb = _format_of(a), _format_of(bt)
    if fa == fb == "e5m2":
        raise TypeError("fp8 gemm: e5m2 . e5m2 is not one of the kernel's "
                        "forms")
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"fp8 gemm writes fp32, bf16 or fp16, not "
                        f"{out_dtype}")
    if a.dim() != 2 or bt.dim() != 2 or a.shape[1] != bt.shape[1]:
        raise ValueError(f"fp8 gemm: a [M, K] and bt [N, K], got "
                         f"{tuple(a.shape)} and {tuple(bt.shape)}")
    m, k = (int(v) for v in a.shape)
    n = int(bt.shape[0])
    if k == 0:
        raise ValueError("fp8 gemm: K is 0")
    sa, sb = _scalar(sa, dev, "sa"), _scalar(sb, dev, "sb")
    a, bt = _kernel_operand(a), _kernel_operand(bt)
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    with torch.cuda.device(dev):
        err = _build.load().ptt_fp8_gemm(
            _build.ptr(a), _build.ptr(bt), _build.ptr(sa), _build.ptr(sb),
            _build.ptr(out), m, n, int(a.shape[1]), FORMAT_CODES[fa],
            FORMAT_CODES[fb], _build.DTYPE_CODES[out_dtype],
            _build.stream_of(a))
    _build.check(err, "ptt_fp8_gemm")
    launches += 1
    return out


# half an ulp of each output type, relative to the value at the bottom of
# its binade (2^-p for p significant bits)
HALF_ULP = {torch.float32: 2.0 ** -24, torch.bfloat16: 2.0 ** -8,
            torch.float16: 2.0 ** -11}


def summation_bound(a, bt, sa, sb):
    """Per output entry, the bound on an fp32 sum of ``K`` products in any
    order: ``K * 2^-24 * sum_k |a_mk bt_nk| * sa * sb`` (the check of the
    kernel against its plain version, before the output's rounding)."""
    k = int(a.shape[1])
    mags = torch.matmul(a.float().abs(), bt.float().abs().t())
    return mags * (k * 2.0 ** -24) * (sa * sb).abs()


def gemm_error(out, a, bt, sa, sb):
    """The kernel's ``out`` against the plain product in fp32 (not
    rounded): ``(max |out - plain|, the largest entry's tolerance, the
    largest error over its entry's tolerance)``, the tolerance of each
    entry being :func:`summation_bound` plus half an ulp of out's type
    at ``|plain| + bound`` (out is rounded once), plus fp16's smallest
    half subnormal."""
    plain = gemm_reference(a, bt, sa, sb, torch.float32)
    bound = summation_bound(a, bt, sa, sb)
    tol = bound + HALF_ULP[out.dtype] * (plain.abs() + bound)
    if out.dtype == torch.float16:
        tol = tol + 2.0 ** -25
    err = (out.float() - plain).abs()
    return (float(err.max()), float(tol.max()),
            float((err / tol.clamp_min(1e-38)).max()))
