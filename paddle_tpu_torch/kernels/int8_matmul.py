"""Weight-only int8 matmul (W8A16): the hand-written Hopper kernel, its
plain version, and the int8 weight rounding rule.

Counterpart of ``paddle_tpu/kernels/int8_matmul.py`` (``int8_matmul``,
``_int8_kernel``; ``int8_matmul_composed`` for the plain version). The
CUDA source is ``paddle_tpu_torch/csrc/int8_matmul.cu``.

The function: ``x @ ((float(w_q) * scale) cast to x's dtype)`` with x
``[..., H]`` fp32 or bf16, ``w_q`` int8 ``[H, N]`` and ``scale`` fp32
``[N]``, summed in fp32 and cast once to x's dtype. The dequantized
weight is rounded to x's dtype BEFORE the product, as ``_dequant`` and
the JAX default path ``int8_matmul_composed`` do.

In the port this kernel IS the quantized projection on the card: every
``QuantizedLinear`` calls :func:`int8_matmul` for every input shape (the
JAX package selects its TPU kernel through the tune cache,
``int8_matmul_select``, which is not ported).

Two designs, chosen by x's dtype (:func:`design`): bf16 runs the
tensor-core kernels (``ptt_int8_matmul_tc``: wgmma on the weight
dequantized in shared memory; the swap-AB kernel up to
:data:`SWAP_MAX_ROWS` rows, split over K chunks, the tiled kernel above),
fp32 the CUDA-core ones (``ptt_int8_matmul``), because the tensor cores
take fp32 only as TF32. ``tc_launches`` and ``cc_launches`` count each
design beside ``launches``.
"""
from __future__ import annotations

import torch

from ..amp import naninf as _naninf
from . import _build

launches = 0
tc_launches = 0
cc_launches = 0
DESIGN_COUNTERS = ("tc_launches", "cc_launches")

X_DTYPES = (torch.float32, torch.bfloat16)
K_CHUNK = 512  # K rows per CTA of the narrow (rows <= 16) CUDA-core kernel
NARROW_ROWS = 16
# the tensor-core design: x rows up to which the swap-AB kernel runs (its
# x tile takes 8 to 256 rows; the crossover with the tiled kernel is
# measured by chip_smoke.py), weight columns of a CTA, K rows of a k-tile
# (a K chunk is a multiple of it), and CTAs per SM the K split aims at
SWAP_TILES = (8, 16, 32, 64, 128, 256)
SWAP_MAX_ROWS = SWAP_TILES[-1]
TC_COLS = 128
TC_KTILE = 64
SWAP_CTAS_PER_SM = 2


def design(dtype):
    """``"tc"`` (tensor cores, bf16 x) or ``"cc"`` (CUDA cores, fp32 x)."""
    return "tc" if dtype == torch.bfloat16 else "cc"


def swap_kchunk(h, n, sms, ctas_per_sm=SWAP_CTAS_PER_SM):
    """K rows per CTA of the swap-AB kernel: enough chunks that the
    ``ceil(n / 128)`` column tiles give about ``ctas_per_sm`` CTAs per
    SM, each chunk a multiple of the 64-row k-tile."""
    col_tiles = -(-n // TC_COLS)
    want = max(1, -(-ctas_per_sm * sms // col_tiles))
    per = -(-h // want)
    return max(TC_KTILE, -(-per // TC_KTILE) * TC_KTILE)


# ------------------------------------------------- the rounding rule
def quantize_weight_with_scales(w, scale):
    """The ONE home of the int8 weight rounding rule
    (``int8_matmul.py:42-52``): float ``[in, out]`` weight + per-out-
    channel scales -> (int8 values, the fp32 scales floored at 1e-8)."""
    wf = w.float()
    s = torch.clamp_min(torch.as_tensor(scale, dtype=torch.float32,
                                        device=wf.device), 1e-8)
    q = torch.clamp(torch.round(wf / s[None, :]), -127, 127)
    return q.to(torch.int8), s


def quantize_weight(w):
    """Float ``[in, out]`` weight -> (int8 values, fp32 per-out-channel
    scales ``[out]``): symmetric absmax over the contraction axis
    (``int8_matmul.py:55-60``)."""
    wf = w.float()
    absmax = wf.abs().amax(dim=0)
    return quantize_weight_with_scales(wf, absmax / 127.0)


def _dequant(w_q, scale, dtype):
    """int8 -> fp32 * scale -> the compute dtype (``int8_matmul.py:63``)."""
    return (w_q.float() * scale).to(dtype)


# ------------------------------------------------------ the function
def int8_matmul_reference(x, w_q, scale):
    """Plain PyTorch version in ``int8_matmul_composed``'s order:
    dequantize the whole weight to x's dtype, then one product summed in
    fp32 and cast once to x's dtype."""
    h = int(x.shape[-1])
    n = int(w_q.shape[1])
    w = _dequant(w_q, scale.reshape(1, n).float(), x.dtype)
    out = torch.matmul(x.reshape(-1, h).float(), w.float()).to(x.dtype)
    return out.reshape(tuple(x.shape[:-1]) + (n,))


def int8_matmul(x, w_q, scale):
    """``x @ dequant(w_q, scale)``; routes on x's device (CPU: the plain
    version; CUDA: the kernel, or a raise)."""
    return _naninf.kernel_op("int8_matmul", _route, x, w_q, scale)


def _route(x, w_q, scale):
    if x.device.type == "cpu":
        return int8_matmul_reference(x, w_q, scale)
    return int8_matmul_cuda(x, w_q, scale)


def int8_matmul_cuda(x, w_q, scale):
    """Launch ``csrc/int8_matmul.cu``: the design :func:`design` gives
    for x's dtype (bf16: the swap-AB kernel up to :data:`SWAP_MAX_ROWS`
    rows, the tiled one above)."""
    global launches, cc_launches
    x2, h, n = _checked(x, w_q, scale)
    rows = int(x2.shape[0])
    if design(x.dtype) == "tc":
        out = _tc_kernel(x2, w_q, scale,
                         "swap" if rows <= SWAP_MAX_ROWS else "tiled")
    else:
        out = torch.empty((rows, n), dtype=x.dtype, device=x.device)
        chunks = -(-h // K_CHUNK)
        partial = None
        if rows <= NARROW_ROWS and chunks > 1:
            partial = torch.empty((chunks, rows, n), dtype=torch.float32,
                                  device=x.device)
        with torch.cuda.device(x.device):
            err = _build.load().ptt_int8_matmul(
                _build.ptr(x2), _build.ptr(w_q), _build.ptr(scale),
                _build.ptr(out),
                None if partial is None else _build.ptr(partial),
                rows, h, n, K_CHUNK, _build.stream_of(x),
            )
        _build.check(err, "ptt_int8_matmul")
        cc_launches += 1
        launches += 1
    return out.reshape(tuple(x.shape[:-1]) + (n,))


def _checked(x, w_q, scale):
    """The kernels' checks of their inputs: (x as ``[rows, H]``, H, N)."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"int8 matmul kernel needs CUDA tensors, got {dev}")
    if x.dtype == torch.float16:
        raise _build.fp16_refused("the W8A16 matmul", 4)
    if x.dtype not in X_DTYPES:
        raise TypeError(f"int8 matmul kernel takes float32 or bfloat16 x, "
                        f"got {x.dtype}")
    if w_q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"int8 matmul kernel takes an int8 weight and "
                        f"float32 scales, got {w_q.dtype} and {scale.dtype}")
    for name, t in (("w_q", w_q), ("scale", scale)):
        if t.device != dev:
            raise ValueError(f"int8 matmul: {name} on {t.device}, x on "
                             f"{dev}")
        if not t.is_contiguous():
            raise ValueError(f"int8 matmul: {name} must be contiguous")
    if w_q.dim() != 2 or tuple(scale.shape) != (int(w_q.shape[1]),):
        raise ValueError(f"int8 matmul: w_q [H, N] and scale [N], got "
                         f"{tuple(w_q.shape)} and {tuple(scale.shape)}")
    h, n = (int(v) for v in w_q.shape)
    if int(x.shape[-1]) != h:
        raise ValueError(f"int8 matmul: x [..., {h}] for w_q "
                         f"{tuple(w_q.shape)}, got {tuple(x.shape)}")
    if h % 8 or n % 8:
        raise ValueError(f"int8 matmul kernel needs H and N multiples of 8, "
                         f"got H={h}, N={n}")
    x2 = x.reshape(-1, h).contiguous()
    if any(t.data_ptr() % 16 for t in (x2, w_q, scale)):
        raise ValueError("int8 matmul kernel needs 16-byte aligned x, "
                         "w_q and scale")
    return x2, h, n


def _tc_kernel(x2, w_q, scale, kernel):
    """One tensor-core kernel, "swap" or "tiled", on checked bf16 x2
    ``[rows, H]``: the out ``[rows, N]``. :func:`int8_matmul_cuda` picks
    the kernel; ``chip_smoke.py``'s crossover sweep names each one."""
    global launches, tc_launches
    rows, h = (int(v) for v in x2.shape)
    n = int(w_q.shape[1])
    if x2.dtype != torch.bfloat16 or kernel not in ("swap", "tiled") or (
            kernel == "swap" and rows > SWAP_MAX_ROWS):
        raise ValueError(f"int8 matmul: no {kernel!r} kernel for "
                         f"{x2.dtype} x of {rows} rows")
    dev = x2.device
    out = torch.empty((rows, n), dtype=x2.dtype, device=dev)
    swap_rows, kchunk, partial = 0, TC_KTILE, None
    if kernel == "swap":
        swap_rows = next(t for t in SWAP_TILES if t >= rows)
        kchunk = swap_kchunk(h, n, _build.sm_count(dev))
        chunks = -(-h // kchunk)
        if chunks > 1:
            partial = torch.empty((chunks, rows, n), dtype=torch.float32,
                                  device=dev)
    with torch.cuda.device(dev):
        err = _build.load().ptt_int8_matmul_tc(
            _build.ptr(x2), _build.ptr(w_q), _build.ptr(scale),
            _build.ptr(out),
            None if partial is None else _build.ptr(partial),
            rows, h, n, kchunk, swap_rows, _build.stream_of(x2),
        )
    _build.check(err, "ptt_int8_matmul_tc")
    tc_launches += 1
    launches += 1
    return out
