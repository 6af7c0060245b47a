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
the float flavour's calls, ``int8_launches`` the int8 one's; a call
launches two kernels (scores, then values), split over chunks of each
row's live slots (:func:`chunk_slots`). The card takes any head dim up
to 256, any number of query heads per kv head and any row length; the
wrapper allocates the kernels' fp32 scratch from the table's shape. The
arena is never padded (its bytes stay the pool's): at a head dim that
is not a multiple of 16 the kernels copy its rows in smaller pieces and
zero-fill them in shared memory up to the next multiple, to which the
wrapper pads q (a copy), and the output is sliced back.
"""
from __future__ import annotations

import math

import torch

from ..quantization.kv import is_quantized
from ..amp import naninf as _naninf
from . import _build
from .flash_attention import check_head_dim, pad_head_dim, padded_head_dim

launches = 0
int8_launches = 0

# (q dtype, arena dtype) pairs the kernel is built for
KV_DTYPES = ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
             (torch.float32, torch.bfloat16))
CHUNK_BYTES = 32 * 1024   # K or V rows of one chunk staged in shared memory
MAX_CHUNK = 256           # slots of a chunk, at most
CHUNK_WORK = 2048         # slots x query heads of one chunk, at most

_COUNTERS = {}            # device -> the kernels' arrival counters (zero)
_REPLACED = []            # outgrown counters, kept (still zero) for the
                          # CUDA graphs that captured them


def chunk_slots(page_size, head_dim, kv_itemsize, group):
    """Slots of a chunk: one CTA's share of a row. As many as fill about
    ``CHUNK_BYTES`` of K or V rows (at most ``MAX_CHUNK``), and at most
    ``CHUNK_WORK / group`` so that a CTA's products stay near the same
    whatever the number of query heads per kv head; a whole number of
    pages, or (a page larger than that) a power of two that divides the
    page. (On the H100, fewer and larger chunks beat more CTAs: every
    chunk costs a CTA's fixed latency and a partial row to sum;
    ``chip_smoke.py`` sweeps the chunk size.)"""
    cap = min(MAX_CHUNK, CHUNK_BYTES // (head_dim * kv_itemsize),
              CHUNK_WORK // group)
    c = max(cap, min(page_size, 16), 1)
    if c >= page_size:
        return c - c % page_size
    return 1 << (c.bit_length() - 1)


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
    return _naninf.kernel_op("paged_attention", _route, q, k_pages, v_pages,
                             page_table, pos, scale)


def _route(q, k_pages, v_pages, page_table, pos, scale):
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
    check_head_dim(d, "paged attention kernel")
    if any(t.data_ptr() % 16 for t in (q, *(a for _, a in arenas))):
        raise ValueError("paged attention kernel needs 16-byte aligned "
                         "q, arenas and scales")
    if h % kvh:
        raise ValueError(f"paged attention kernel needs H a multiple of "
                         f"kvH, got H={h}, kvH={kvh}")
    if page_table.dim() != 2 or page_table.shape[0] != b \
            or tuple(pos.shape) != (b,):
        raise ValueError(
            f"paged attention: page_table [{b}, P] and pos [{b}], got "
            f"{tuple(page_table.shape)} and {tuple(pos.shape)}"
        )
    return b, h, d, ps, kvh, int(page_table.shape[1])


def _workspace(q, kv_itemsize, b, h, d, ps, kvh, width):
    """The kernels' scratch for one call: ``(chunk, max_chunks, scores,
    stats, partials, counters)``. Scores fp32 ``[B, H, P * ps]``, chunk
    statistics fp32 ``[B, H, max_chunks, 2]``, partial value rows fp32
    ``[B, H, max_chunks, D]`` (one allocation, 16-byte aligned parts),
    and the per-device arrival counters ``[B, kvH]``, which the kernels
    leave at zero."""
    dev = q.device
    chunk = chunk_slots(ps, d, kv_itemsize, h // kvh)
    s_virt = width * ps
    max_chunks = -(-s_virt // chunk)
    sizes = [b * h * s_virt, b * h * max_chunks * 2, b * h * max_chunks * d]
    sizes = [-(-n // 4) * 4 for n in sizes]
    ws = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    parts = torch.split(ws, sizes)
    counters = _COUNTERS.get(dev)
    if counters is None or counters.numel() < b * kvh:
        if counters is not None:
            _REPLACED.append(counters)  # a captured program may use it
        counters = torch.zeros(b * kvh, dtype=torch.int32, device=dev)
        _COUNTERS[dev] = counters
    return (chunk, max_chunks, *parts, counters)


def paged_attention_cuda(q, k_pages, v_pages, page_table, pos, scale=None):
    """Launch ``csrc/paged_attention.cu`` over float arenas."""
    global launches
    if torch.float16 in (q.dtype, k_pages.dtype, v_pages.dtype):
        raise _build.fp16_refused("paged attention", 4)
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
    dp = padded_head_dim(d)
    qp = pad_head_dim(q, dp)
    out = torch.empty_like(qp)
    chunk, max_chunks, *ws = _workspace(q, k_pages.element_size(), b, h, dp,
                                        ps, kvh, width)
    with torch.cuda.device(q.device):
        err = lib.ptt_paged_attention_fwd(
            _build.ptr(qp), _build.ptr(k_pages), _build.ptr(v_pages),
            _build.ptr(page_table), _build.ptr(pos), _build.ptr(out),
            *(_build.ptr(t) for t in ws), b, h, kvh, dp, d, ps, width, chunk,
            max_chunks, codes[q.dtype], codes[k_pages.dtype], float(scale),
            _build.stream_of(q),
        )
    _build.check(err, "ptt_paged_attention_fwd")
    launches += 1
    return out if dp == d else out[..., :d].contiguous()


def paged_attention_int8_cuda(q, k_pages, v_pages, page_table, pos,
                              scale=None):
    """Launch ``csrc/paged_attention.cu`` over int8 arenas
    (``QuantizedKV`` k_pages and v_pages)."""
    global int8_launches
    if not (is_quantized(k_pages) and is_quantized(v_pages)):
        raise TypeError("the int8 paged attention kernel takes QuantizedKV "
                        "arenas")
    if q.dtype == torch.float16:
        raise _build.fp16_refused("int8 paged attention", 4)
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
    dp = padded_head_dim(d)
    qp = pad_head_dim(q, dp)
    out = torch.empty_like(qp)
    chunk, max_chunks, *ws = _workspace(q, 1, b, h, dp, ps, kvh, width)
    with torch.cuda.device(q.device):
        err = lib.ptt_paged_attention_int8_fwd(
            _build.ptr(qp), _build.ptr(k_pages.q), _build.ptr(k_pages.scale),
            _build.ptr(v_pages.q), _build.ptr(v_pages.scale),
            _build.ptr(page_table), _build.ptr(pos), _build.ptr(out),
            *(_build.ptr(t) for t in ws), b, h, kvh, dp, d, ps, width, chunk,
            max_chunks, _build.DTYPE_CODES[q.dtype], float(scale),
            _build.stream_of(q),
        )
    _build.check(err, "ptt_paged_attention_int8_fwd")
    int8_launches += 1
    return out if dp == d else out[..., :d].contiguous()
