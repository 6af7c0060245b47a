"""KV-cache storage: float caches and the int8 cache (counterpart of
``paddle_tpu/quantization/kv.py``).

An int8 cache is a :class:`QuantizedKV`: int8 values ``[..., S, kvH, D]``
plus one fp32 scale per stored token and kv head ``[..., S, kvH]``
(symmetric absmax over the head dim), so a resident token costs
``kvH * (D + 4)`` bytes instead of bf16's ``kvH * D * 2``. Every write
quantizes the incoming tokens with :func:`quantize_kv` (quantize on
write), so the same token quantizes identically in ``generate``, the
slab engine and the paged engine; the composed attention reads
dequantize to the compute dtype (:func:`read_dense`), and the paged
attention kernel dequantizes int8 rows in registers instead. Zeroed
storage (scale 0) dequantizes to exact zeros.

Unlike the JAX package, whose arrays are immutable, every write here
updates the cache tensors IN PLACE and returns the cache, so callers
keep the JAX call shape (``cache = write_...(cache, ...)``) while no
copy of a multi-gigabyte arena is made per step. The prefix cache's
``gather_block_from_pages`` is not ported (nor is the prefix cache).
"""
from __future__ import annotations

import torch

# symmetric int8: values in [-127, 127] (the -128 code is unused, so the
# scale maps absmax exactly onto the grid edge)
QMAX = 127.0
# absmax floor: an all-zero token quantizes to (0, tiny scale) and
# dequantizes to exact 0 rather than dividing by zero
_EPS = 1e-8

# cache dtype names stored quantized (models/generation.py
# normalize_cache_dtype accepts them)
QUANT_CACHE_DTYPES = ("int8",)


class QuantizedKV:
    """One int8 cache: ``q`` int8 ``[..., S, kvH, D]`` and ``scale``
    fp32 ``[..., S, kvH]``. ``.dtype`` and ``.shape`` are the values',
    as the pools and the model read them off a cache."""

    __slots__ = ("q", "scale")

    def __init__(self, q, scale):
        self.q = q
        self.scale = scale

    @property
    def dtype(self):
        return self.q.dtype

    @property
    def shape(self):
        return self.q.shape

    def __repr__(self):
        return (f"QuantizedKV(q={tuple(self.q.shape)}, "
                f"scale={tuple(self.scale.shape)})")


def is_quantized(cache):
    return isinstance(cache, QuantizedKV)


def alloc_quantized(shape, device=None):
    """Zeroed int8 values and zeroed scales for a cache of logical shape
    ``[..., S, kvH, D]`` (zero scales dequantize to exact zeros)."""
    shape = tuple(int(s) for s in shape)
    return QuantizedKV(
        torch.zeros(shape, dtype=torch.int8, device=device),
        torch.zeros(shape[:-1], dtype=torch.float32, device=device),
    )


def quantize_kv(x):
    """``[..., D]`` float -> (int8 values ``[..., D]``, fp32 scales
    ``[...]``) (``kv.py:100-119``): scale = max|x| / 127 floored at 1e-8,
    rounded through the bf16 grid (so a token quantizes to the same bytes
    whatever the shape of the program that wrote it), then values =
    round-half-even(x / scale) clipped to [-127, 127]."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1)
    scale = (torch.clamp_min(absmax, _EPS) / QMAX).to(torch.bfloat16).float()
    q = torch.clamp(torch.round(xf / scale[..., None]), -QMAX, QMAX)
    return q.to(torch.int8), scale


def dequantize_kv(q, scale, dtype):
    """int8 values + scales -> dense tensor in the compute ``dtype``."""
    return (q.float() * scale[..., None]).to(dtype)


def kv_token_bytes(kv_heads, head_dim, dtype):
    """Device bytes ONE cached token costs per K-or-V array in ``dtype``
    (int8 counts its fp32 scale: equal-memory comparisons must not
    flatter quantized pools)."""
    item = torch.empty((), dtype=dtype).element_size()
    if dtype == torch.int8:
        return kv_heads * (head_dim * item + 4)
    return kv_heads * head_dim * item


# ------------------------------------------------------------- cache writes
def write_at_pos(cache, val, pos):
    """Prefill / whole-batch write, in place: ``val`` ``[B, S, kvH, D]``
    lands at cache positions ``[pos, pos + S)`` (``kv.py:147``)."""
    p = int(pos)
    s = int(val.shape[1])
    if is_quantized(cache):
        q, sc = quantize_kv(val)
        cache.q[:, p:p + s] = q
        cache.scale[:, p:p + s] = sc
        return cache
    cache[:, p:p + s] = val.to(cache.dtype)
    return cache


def write_at_rows(cache, val, rows, cols):
    """Per-row decode write, in place (continuous batching): ``val``
    ``[B, S, kvH, D]`` at each row's own depth; ``rows`` [B, 1] and
    ``cols`` [B, S] index tensors (``kv.py:162``)."""
    r, c = rows.long(), cols.long()
    if is_quantized(cache):
        q, sc = quantize_kv(val)
        cache.q[r, c] = q
        cache.scale[r, c] = sc
        return cache
    cache[r, c] = val.to(cache.dtype)
    return cache


def write_paged(cache, val, page, offset):
    """Paged decode write, in place: ``val`` ``[B, kvH, D]`` (this step's
    token per row) at each row's ``(page, offset)`` (``kv.py:175``).
    Free rows all write the garbage page 0; which of them lands there
    does not matter."""
    pg, off = page.long(), offset.long()
    if is_quantized(cache):
        q, sc = quantize_kv(val)
        cache.q[pg, off] = q
        cache.scale[pg, off] = sc
        return cache
    cache[pg, off] = val.to(cache.dtype)
    return cache


def read_dense(cache, dtype):
    """The composed attention read (``kv.py:187``): an int8 cache
    dequantizes to the compute ``dtype``; a plain cache passes through
    (attention upcasts at the product)."""
    if is_quantized(cache):
        return dequantize_kv(cache.q, cache.scale, dtype)
    return cache


# ------------------------------------------------------------ adoption
def adopt_into_slab(dst, blk, slot):
    """Copy a prefilled ``[1, bucket, ...]`` block into row ``slot`` of
    the decode slab, in place (``kv.py:224``)."""
    s = int(slot)
    if is_quantized(dst):
        n = int(blk.q.shape[1])
        dst.q[s:s + 1, :n] = blk.q
        dst.scale[s:s + 1, :n] = blk.scale
        return dst
    dst[s:s + 1, : int(blk.shape[1])] = blk.to(dst.dtype)
    return dst


def adopt_into_pages(arena, blk, page_ids, n_pages, page_size):
    """Scatter a prefilled ``[1, bucket, ...]`` block into the arena as
    ``n_pages`` whole pages at ``page_ids``, in place (``kv.py:258``;
    ids past the request's claim point at the garbage page 0)."""
    ids = page_ids.long()
    if is_quantized(arena):
        kvh, d = int(blk.q.shape[2]), int(blk.q.shape[3])
        arena.q[ids] = blk.q[0].reshape(n_pages, page_size, kvh, d)
        arena.scale[ids] = blk.scale[0].reshape(n_pages, page_size, kvh)
        return arena
    pages = blk[0].reshape(n_pages, page_size, int(blk.shape[2]),
                           int(blk.shape[3]))
    arena[ids] = pages.to(arena.dtype)
    return arena
