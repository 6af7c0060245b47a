"""Autoregressive decoding over a KV cache (counterpart of
``paddle_tpu/models/generation.py``).

PyTorch runs eagerly, so where the JAX package traces prefill plus a
``lax.scan`` of decode steps into one program, the port runs prefill
and then one :func:`decode_step` per token from Python, under
``torch.inference_mode()``. The KV cache is still one static
``[B, S_max, kvH, D]`` buffer per layer, written in place.

Sampling draws its randomness from :mod:`..serving.sampling_keys`: the
token that lands at cache position ``j`` of request ``i`` is sampled
with noise that depends only on (seed, i, j), so streams reproduce for a
given seed and workload. They do not reproduce the JAX package's
threefry bits. Beam search is not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..quantization.kv import QUANT_CACHE_DTYPES, alloc_quantized

DEFAULT_CACHE_DTYPE = "bfloat16"
ALLOWED_CACHE_DTYPES = ("float32", "bfloat16") + QUANT_CACHE_DTYPES
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int8": torch.int8}


def filter_logits(logits, temperature, top_k, top_p):
    """Temperature, top-k and nucleus filtering: [B, V] -> fp32 [B, V]
    with dropped entries at -inf (``generation.py:26``)."""
    scaled = logits.float() / max(float(temperature), 1e-6)
    if top_k and top_k > 0:
        top_k = min(int(top_k), int(logits.shape[-1]))
        kth = torch.sort(scaled, dim=-1).values[:, -top_k][:, None]
        scaled = scaled.masked_fill(scaled < kth, float("-inf"))
    if top_p is not None and top_p < 1.0:
        srt = torch.sort(scaled, dim=-1, descending=True).values
        probs = torch.softmax(srt, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = cum - probs < top_p
        keep[:, 0] = True  # the argmax token always survives
        cutoff = torch.where(keep, srt, torch.full_like(srt, float("inf")))
        cutoff = cutoff.min(dim=-1, keepdim=True).values
        scaled = scaled.masked_fill(scaled < cutoff, float("-inf"))
    return scaled


def _select_next(logits, do_sample, temperature, top_k, top_p, keys=None):
    """logits [B, V] -> next token ids [B] (int64, on logits' device).
    Sampling needs ``keys``: one (request_key, position) pair per row
    (:func:`..serving.sampling_keys.sample_rows`)."""
    if not do_sample:
        return torch.argmax(logits, dim=-1)
    from ..serving.sampling_keys import sample_rows

    return sample_rows(filter_logits(logits, temperature, top_k, top_p),
                       keys)


def normalize_cache_dtype(cache_dtype):
    """``cache_dtype`` knob -> canonical name; ``None`` is the default.
    ``"int8"`` is the quantized cache (:class:`QuantizedKV` pairs); any
    other dtype is a ValueError naming the allowed set."""
    if cache_dtype is None:
        return DEFAULT_CACHE_DTYPE
    if isinstance(cache_dtype, torch.dtype):
        name = str(cache_dtype).replace("torch.", "")
    elif str(cache_dtype) == "bfloat16":
        name = "bfloat16"
    else:
        try:
            name = np.dtype(cache_dtype).name
        except TypeError:
            raise ValueError(
                f"unknown cache_dtype {cache_dtype!r}; allowed: "
                f"{ALLOWED_CACHE_DTYPES}"
            ) from None
    if name not in ALLOWED_CACHE_DTYPES:
        raise ValueError(
            f"cache_dtype {cache_dtype!r} is not a supported KV-cache "
            f"storage dtype; allowed: {ALLOWED_CACHE_DTYPES}"
        )
    return name


def cache_torch_dtype(cache_dtype):
    return _DTYPES[normalize_cache_dtype(cache_dtype)]


def alloc_kv_caches(cfg, B, S_max, cache_dtype=None, device=None):
    """Per-layer zeroed KV buffers ``[B, S_max, kvH, D]`` x2 on
    ``device`` (``generation.py:105``; None: the first CUDA card, or a
    raise without one); ``QuantizedKV`` pairs for ``"int8"``."""
    device = resolve_device(device)
    dtype = cache_torch_dtype(cache_dtype)
    shape = (B, S_max, cfg.kv_heads, cfg.head_dim)
    if dtype == torch.int8:
        return [(alloc_quantized(shape, device), alloc_quantized(shape, device))
                for _ in range(cfg.num_hidden_layers)]
    return [
        (torch.zeros(shape, dtype=dtype, device=device),
         torch.zeros(shape, dtype=dtype, device=device))
        for _ in range(cfg.num_hidden_layers)
    ]


def prefill(net, ids, caches, length=None, pos=0):
    """Run the prompt through the cache path in one pass (caches filled
    in place at [pos, pos + S)). ``ids`` may be right-padded to a bucket:
    ``length`` picks the logits row at ``length - 1``. Returns
    (next-token logits [B, V], caches)."""
    with torch.inference_mode():
        logits, caches = net(ids, caches=caches, pos=int(pos))
        if length is None:
            return logits[:, -1, :], caches
        return logits[:, int(length) - 1, :], caches


def decode_step(net, tok, caches, pos, page_table=None):
    """One decode step: ``tok`` [B, 1]; ``pos`` an int (whole batch) or
    an int [B] tensor (every row at its own depth). With ``page_table``
    the caches are page arenas. Returns (logits [B, V], caches)."""
    kw = {} if page_table is None else {"page_table": page_table}
    with torch.inference_mode():
        logits, caches = net(tok, caches=caches, pos=pos, **kw)
        return logits[:, -1, :], caches


def _as_ids(input_ids, device):
    if isinstance(input_ids, torch.Tensor):
        return input_ids.to(device=device, dtype=torch.long)
    return torch.as_tensor(np.asarray(input_ids), dtype=torch.long,
                           device=device)


def generate(net, input_ids, max_new_tokens=32, do_sample=False,
             temperature=1.0, top_k=0, top_p=1.0, eos_token_id=None,
             seed=0, num_beams=1, cache_dtype=None):
    """Greedy or top-k/top-p sampled decode; returns an int64 tensor
    ``[B, S + max_new_tokens]`` on the net's device. Rows that emitted
    ``eos_token_id`` keep emitting it. ``cache_dtype`` is the KV storage
    dtype (bf16 by default; ``"float32"`` for exact parity with the
    cache-free forward of an fp32 net; ``"int8"`` for the quantized
    cache). Sampled row ``b`` draws as the
    ``b``-th request of a serving engine seeded with ``seed`` would."""
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    if num_beams > 1:
        raise NotImplementedError(
            "beam search is not ported yet (greedy and sampling are)"
        )
    from ..serving.sampling_keys import SamplingKeySource

    dev = net.device
    ids = _as_ids(input_ids, dev)
    B, S = int(ids.shape[0]), int(ids.shape[1])
    keys = None
    if do_sample:
        src = SamplingKeySource(seed)
        keys = [src.next_request_key() for _ in range(B)]
    caches = alloc_kv_caches(net.config, B, S + max_new_tokens,
                             cache_dtype, device=dev)
    with torch.inference_mode():
        logits, caches = prefill(net, ids, caches)
        nxt = _select_next(logits, do_sample, temperature, top_k, top_p,
                           None if keys is None
                           else [(k, S) for k in keys])
        finished = (nxt == eos_token_id) if eos_token_id is not None \
            else None
        out = [nxt]
        for i in range(1, max_new_tokens):
            pos = S + i - 1
            logits, caches = decode_step(net, nxt[:, None], caches, pos)
            nxt = _select_next(logits, do_sample, temperature, top_k,
                               top_p, None if keys is None
                               else [(k, pos + 1) for k in keys])
            if finished is not None:
                nxt = torch.where(finished, torch.full_like(
                    nxt, eos_token_id), nxt)
                finished = finished | (nxt == eos_token_id)
            out.append(nxt)
        return torch.cat([ids, torch.stack(out, dim=1)], dim=1)
