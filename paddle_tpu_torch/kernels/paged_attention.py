"""Paged decode attention over a page arena: the hand-written Hopper
kernels (float arenas and int8 arenas) and their plain versions.

Counterpart of ``paddle_tpu/kernels/paged_attention.py``
(``paged_attention_fused``: float flavour ``_paged_kernel`` and int8
flavour ``_paged_kernel_quant``, both over ``_paged_body``;
``gather_pages`` for the plain versions). The CUDA source is
``paddle_tpu_torch/csrc/paged_attention.cu``.

Shape contract (as in the TPU module): q ``[B, 1, H, D]``, k_pages /
v_pages ``[N, page_size, kvH, D]``, page_table ``[B, P]`` int32 (page 0
is the garbage page the unused tail points at), pos ``[B]`` int32; row b
attends cache slots ``[0, pos[b]]`` inclusive. Scores and softmax are
fp32 and exact; the probabilities are rounded to q's dtype before the
value product (``paged_attention.py:227``). An int8 arena is a
``QuantizedKV`` (int8 values ``[N, page_size, kvH, D]``, fp32 scales
``[N, page_size, kvH]``); its rows are dequantized as ``float(q) *
scale`` in fp32, not rounded to q's dtype (``paged_attention.py:262``).

In the port these kernels ARE the paged decode attention on the card;
the JAX package only selects its TPU kernel through the tune cache
(``paged_attention_select``), which is not ported. ``launches`` counts
the float flavour, ``int8_launches`` the int8 one.
"""
from __future__ import annotations

import math

import torch

from ..quantization.kv import is_quantized
from . import _build

launches = 0
int8_launches = 0

MAX_GROUP = 8             # query heads per kv head the kernel takes
HEAD_DIMS = (16, 32, 64, 128, 256)  # others: ROADMAP.md queue C
WARPS = 8                 # warps per CTA (kWarps in the source)
SMEM_LIMIT = 232448 - 256  # dynamic shared memory a CTA may use, bytes
# (q dtype, arena dtype) pairs the kernel is built for
KV_DTYPES = ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
             (torch.float32, torch.bfloat16))


def gather_pages(pages, page_table):
    """``[N, ps, ...]`` arena (values ``[N, ps, kvH, D]`` or scales
    ``[N, ps, kvH]``) + ``[B, P]`` table -> ``[B, P * ps, ...]`` logical
    cache (``paged_attention.py:58``)."""
    b, p = (int(v) for v in page_table.shape)
    ps = int(pages.shape[1])
    return pages[page_table.long()].reshape(b, p * ps, *pages.shape[2:])


def gather_pages_fp32(pages, page_table):
    """The logical cache in fp32: a float arena upcast, an int8 arena
    dequantized as ``float(q) * scale`` (the kernels' load epilogues)."""
    if is_quantized(pages):
        return (gather_pages(pages.q, page_table).float()
                * gather_pages(pages.scale, page_table)[..., None])
    return gather_pages(pages, page_table).float()


def paged_attention_reference(q, k_pages, v_pages, page_table, pos,
                              scale=None):
    """Plain PyTorch version of the kernels' function: gather the pages
    in fp32 (int8 arenas dequantized), fp32 scores, mask columns past
    ``pos``, exact fp32 softmax, probabilities rounded to q's dtype, fp32
    value product, q's dtype out."""
    b, _, h, d = (int(v) for v in q.shape)
    kvh = int(k_pages.shape[2])
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    kk = gather_pages_fp32(k_pages, page_table)
    vv = gather_pages_fp32(v_pages, page_table)
    if kvh != h:
        rep = h // kvh
        kk = kk.repeat_interleave(rep, dim=2)
        vv = vv.repeat_interleave(rep, dim=2)
    s_virt = int(kk.shape[1])
    qt = q.float().transpose(1, 2)                          # [B, H, 1, D]
    s = torch.matmul(qt, kk.permute(0, 2, 3, 1)) * scale    # [B, H, 1, S]
    cols = torch.arange(s_virt, device=q.device)
    valid = cols[None, :] <= pos.long()[:, None]            # [B, S]
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1).to(q.dtype).float()
    out = torch.matmul(p, vv.transpose(1, 2))               # [B, H, 1, D]
    return out.transpose(1, 2).to(q.dtype)


def paged_attention(q, k_pages, v_pages, page_table, pos, scale=None):
    """Paged decode attention over float or int8 (``QuantizedKV``)
    arenas; routes on q's device (CPU: the plain version; CUDA: the
    kernel of the arenas' flavour, or a raise)."""
    quant = is_quantized(k_pages)
    if quant != is_quantized(v_pages):
        raise ValueError("k_pages and v_pages must share quantization")
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pages, v_pages, page_table,
                                         pos, scale)
    if quant:
        return paged_attention_int8_cuda(q, k_pages, v_pages, page_table,
                                         pos, scale)
    return paged_attention_cuda(q, k_pages, v_pages, page_table, pos, scale)


def _check_common(q, arenas, page_table, pos):
    """Checks both flavours share; returns (b, h, d, ps, kvh, width)."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"paged attention kernel needs CUDA tensors, "
                         f"got {dev}")
    for name, t in (*arenas, ("page_table", page_table), ("pos", pos)):
        if t.device != dev:
            raise ValueError(f"paged attention: {name} on {t.device}, "
                             f"q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"paged attention: {name} must be contiguous")
    if not q.is_contiguous():
        raise ValueError("paged attention: q must be contiguous")
    if page_table.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError("paged attention: page_table and pos must be int32")
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(
            f"paged attention is the decode step: q [B, 1, H, D], got "
            f"{tuple(q.shape)}"
        )
    b, _, h, d = (int(v) for v in q.shape)
    k_pages, v_pages = arenas[0][1], arenas[1][1]
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(
            f"paged attention: k/v arenas must be one [N, ps, kvH, D] "
            f"shape, got {tuple(k_pages.shape)}, {tuple(v_pages.shape)}"
        )
    _, ps, kvh, dk = (int(v) for v in k_pages.shape)
    if dk != d:
        raise ValueError(f"head_dim mismatch: q D={d}, pages D={dk}")
    if ps < 1 or ps & (ps - 1):
        raise ValueError(f"paged attention kernel needs a power-of-two "
                         f"page_size, got {ps}")
    if d not in HEAD_DIMS:
        raise ValueError(f"paged attention kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {d} (other head dims are "
                         f"refused: ROADMAP.md queue C)")
    if any(t.data_ptr() % 16 for t in (q, *(a for _, a in arenas))):
        raise ValueError("paged attention kernel needs 16-byte aligned "
                         "q, arenas and scales")
    if h % kvh or h // kvh > MAX_GROUP:
        raise ValueError(
            f"paged attention kernel needs H a multiple of kvH with at most "
            f"{MAX_GROUP} query heads per kv head, got H={h}, kvH={kvh}"
        )
    if page_table.dim() != 2 or page_table.shape[0] != b \
            or tuple(pos.shape) != (b,):
        raise ValueError(
            f"paged attention: page_table [{b}, P] and pos [{b}], got "
            f"{tuple(page_table.shape)} and {tuple(pos.shape)}"
        )
    width = int(page_table.shape[1])
    g = h // kvh
    smem = 4 * (g * d + WARPS * d + g * width * ps)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"paged attention kernel keeps the score row in shared memory: "
            f"{g} heads x {width * ps} slots needs {smem} bytes, more than "
            f"{SMEM_LIMIT}"
        )
    return b, h, d, ps, kvh, width


def paged_attention_cuda(q, k_pages, v_pages, page_table, pos, scale=None):
    """Launch ``csrc/paged_attention.cu`` over float arenas."""
    global launches
    if (q.dtype, k_pages.dtype) not in KV_DTYPES \
            or v_pages.dtype != k_pages.dtype:
        raise TypeError(
            f"paged attention kernel takes q and arenas of one dtype "
            f"(float32 or bfloat16), or a float32 q over bfloat16 arenas; "
            f"got q {q.dtype}, k {k_pages.dtype}, v {v_pages.dtype}"
        )
    b, h, d, ps, kvh, width = _check_common(
        q, (("k_pages", k_pages), ("v_pages", v_pages)), page_table, pos)
    codes = _build.DTYPE_CODES
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    lib = _build.load()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.ptt_paged_attention_fwd(
            _build.ptr(q), _build.ptr(k_pages), _build.ptr(v_pages),
            _build.ptr(page_table), _build.ptr(pos), _build.ptr(out),
            b, h, kvh, d, ps, width, codes[q.dtype], codes[k_pages.dtype],
            float(scale), _build.stream_of(q),
        )
    _build.check(err, "ptt_paged_attention_fwd")
    launches += 1
    return out


def paged_attention_int8_cuda(q, k_pages, v_pages, page_table, pos,
                              scale=None):
    """Launch ``csrc/paged_attention.cu`` over int8 arenas
    (``QuantizedKV`` k_pages and v_pages)."""
    global int8_launches
    if not (is_quantized(k_pages) and is_quantized(v_pages)):
        raise TypeError("the int8 paged attention kernel takes QuantizedKV "
                        "arenas")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"int8 paged attention kernel takes a float32 or "
                        f"bfloat16 q, got {q.dtype}")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.q.dtype != torch.int8 or t.scale.dtype != torch.float32:
            raise TypeError(
                f"int8 paged attention: {name} must hold int8 values and "
                f"float32 scales, got {t.q.dtype} and {t.scale.dtype}")
        if tuple(t.scale.shape) != tuple(t.q.shape[:3]):
            raise ValueError(
                f"int8 paged attention: {name} scales must be [N, ps, kvH] "
                f"{tuple(t.q.shape[:3])}, got {tuple(t.scale.shape)}")
    b, h, d, ps, kvh, width = _check_common(
        q, (("k_pages", k_pages.q), ("v_pages", v_pages.q),
            ("k_scale", k_pages.scale), ("v_scale", v_pages.scale)),
        page_table, pos)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    lib = _build.load()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.ptt_paged_attention_int8_fwd(
            _build.ptr(q), _build.ptr(k_pages.q), _build.ptr(k_pages.scale),
            _build.ptr(v_pages.q), _build.ptr(v_pages.scale),
            _build.ptr(page_table), _build.ptr(pos), _build.ptr(out),
            b, h, kvh, d, ps, width, _build.DTYPE_CODES[q.dtype],
            float(scale), _build.stream_of(q),
        )
    _build.check(err, "ptt_paged_attention_int8_fwd")
    int8_launches += 1
    return out
