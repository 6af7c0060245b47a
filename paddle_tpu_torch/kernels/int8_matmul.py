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
"""
from __future__ import annotations

import torch

from . import _build

launches = 0

X_DTYPES = (torch.float32, torch.bfloat16)
K_CHUNK = 512  # K rows per CTA of the narrow (rows <= 16) kernel
NARROW_ROWS = 16


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
    if x.device.type == "cpu":
        return int8_matmul_reference(x, w_q, scale)
    return int8_matmul_cuda(x, w_q, scale)


def int8_matmul_cuda(x, w_q, scale):
    """Launch ``csrc/int8_matmul.cu``."""
    global launches
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"int8 matmul kernel needs CUDA tensors, got {dev}")
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
    rows = int(x2.shape[0])
    out = torch.empty((rows, n), dtype=x.dtype, device=dev)
    chunks = -(-h // K_CHUNK)
    partial = None
    if rows <= NARROW_ROWS and chunks > 1:
        partial = torch.empty((chunks, rows, n), dtype=torch.float32,
                              device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.ptt_int8_matmul(
            _build.ptr(x2), _build.ptr(w_q), _build.ptr(scale),
            _build.ptr(out),
            None if partial is None else _build.ptr(partial),
            rows, h, n, K_CHUNK, _build.DTYPE_CODES[x.dtype],
            _build.stream_of(x),
        )
    _build.check(err, "ptt_int8_matmul")
    launches += 1
    return out.reshape(tuple(x.shape[:-1]) + (n,))
