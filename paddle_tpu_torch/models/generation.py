"""Autoregressive decoding over a KV cache (counterpart of
``paddle_tpu/models/generation.py``).

The JAX package traces the prefill and a ``lax.scan`` of decode steps
into one program per signature (``_build_decode``, its ``sig`` tuple) and
caches it on the net. The port does the same with one CUDA graph per
signature: :func:`generate` captures the whole prefill and decode of its
first call for a signature (the body runs once eagerly on the capture
stream, that call's result, then is captured, as ``serving/programs.py``
captures the engines' steps), keeps it in ``net._generate_cache`` under
JAX's ``sig`` and replays it on later calls. Positions are static per
signature; the runtime inputs are the prompt ids, the reciprocal of the
temperature, the EOS id and, when sampling, every position's Gumbel
noise, drawn before the program and copied in once. So the host does one replay
a call and reads nothing back mid-decode; EOS freezing runs inside. The
weights enter by address: an in-place update (an optimizer step, a live
reload's copy) shows in the next call, and a call that finds a parameter
or buffer replaced (another address), or ``net.fusions`` changed, captures
again. On the CPU the same body runs as a plain call over the same static
inputs. ``graphs=False`` runs the body eagerly with the noise drawn
step by step, the reference the program is held against. The KV cache is
one ``[B, S_max, kvH, D]`` buffer per layer, written in place.

Sampling draws its randomness from :mod:`..serving.sampling_keys`: the
token that lands at cache position ``j`` of request ``i`` is sampled
with noise that depends only on (seed, i, j), so streams reproduce for a
given seed and workload. They do not reproduce the JAX package's
threefry bits.

Beam search (``num_beams > 1``, :func:`beam_search`) folds the beams into
the batch, ``[B * num_beams]`` rows over one slab cache, and runs the
same prefill and decode steps from a Python loop, where the JAX package
scans them; its top-k keeps the lower index on a tie, as
``jax.lax.top_k`` does.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..quantization.kv import QUANT_CACHE_DTYPES, alloc_quantized, select_rows

DEFAULT_CACHE_DTYPE = "bfloat16"
ALLOWED_CACHE_DTYPES = ("float32", "bfloat16") + QUANT_CACHE_DTYPES
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int8": torch.int8}


def inverse_temperature(temperature):
    """The fp32 reciprocal the logits are scaled by, as a Python float
    (``1 / max(temperature, 1e-6)``, rounded once to fp32)."""
    return float(np.float32(1.0) / np.float32(max(float(temperature),
                                                  1e-6)))


def filter_logits(logits, temperature, top_k, top_p):
    """Temperature, top-k and nucleus filtering: [B, V] -> fp32 [B, V]
    with dropped entries at -inf (``generation.py:26``). The logits are
    multiplied by the fp32 reciprocal of the temperature (JAX divides),
    so that a program can take it as a device scalar bit for bit."""
    return _filter_scaled(logits.float() * inverse_temperature(temperature),
                          top_k, top_p)


def _filter_scaled(scaled, top_k, top_p):
    """Top-k and nucleus filtering of temperature-scaled fp32 logits."""
    if top_k and top_k > 0:
        top_k = min(int(top_k), int(scaled.shape[-1]))
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


def top_k_stable(x, k):
    """``(values, indices)`` of the ``k`` largest entries of each row of
    ``x`` ``[..., N]``, in descending order, the lower index first on a
    tie (``jax.lax.top_k``'s rule, which ``torch.topk`` does not promise
    on a card): a stable descending sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


# a frozen beam's log-probability of every token but EOS
_NEG = -1e30


def beam_search(net, ids, max_new, num_beams, eos_token_id=None,
                cache_dtype=None):
    """Beam search with the beams folded into the batch (the JAX
    ``_beam_decode_ids``, ``generation.py:240-330``): ``[B * k]`` rows
    share one slab cache; each step scores ``[B, k * V]`` in fp32, keeps
    the top k continuations and gathers the caches by surviving beam
    after the step's write. A finished beam is frozen: EOS at
    log-probability 0, every other token at -1e30, so its score stays
    comparable. Returns the best beam of each batch row (beam 0, the
    top-k order keeps beams sorted by score), ``[B, S + max_new]``.
    ``eos_token_id`` is None, an int, or a 0-d device tensor (the
    program's input)."""
    B, S = int(ids.shape[0]), int(ids.shape[1])
    k = int(num_beams)
    eos = eos_token_id
    has_eos = eos is not None
    caches = alloc_kv_caches(net.config, B, S + max_new, cache_dtype,
                             device=ids.device)
    logits, caches = prefill(net, ids, caches)
    logp = torch.log_softmax(logits.float(), dim=-1)            # [B, V]
    V = int(logp.shape[-1])
    # first expansion: the top-k tokens of each prompt seed the beams
    scores, tok0 = top_k_stable(logp, k)                         # [B, k]
    finished = (tok0 == eos) if has_eos else None
    # the beams share the prompt's cache: each row repeated k times
    rep = torch.arange(B, device=ids.device).repeat_interleave(k)
    caches = [(select_rows(kc, rep), select_rows(vc, rep))
              for kc, vc in caches]
    beam_toks = torch.zeros((B, k, max_new), dtype=torch.long,
                            device=ids.device)
    beam_toks[:, :, 0] = tok0
    if has_eos:
        frozen = torch.full((V,), _NEG, dtype=torch.float32,
                            device=ids.device)
        # by a device index: the program's EOS is a device scalar
        frozen.index_fill_(0, torch.as_tensor(eos, device=ids.device)
                           .reshape(1), 0.0)
    base = torch.arange(B, device=ids.device)[:, None] * k
    for col in range(max_new - 1):
        tok = beam_toks[:, :, col].reshape(B * k)
        logits, caches = decode_step(net, tok[:, None], caches, S + col)
        lp = torch.log_softmax(logits.float(), dim=-1).reshape(B, k, V)
        if has_eos:
            # frozen beams: only EOS continues, at no cost
            lp = torch.where(finished[..., None], frozen, lp)
        total = scores[..., None] + lp                           # [B, k, V]
        scores, idx = top_k_stable(total.reshape(B, k * V), k)
        src = idx // V              # [B, k] the beam each winner extends
        tok2 = idx % V
        beam_toks = torch.gather(beam_toks, 1,
                                 src[..., None].expand(B, k, max_new))
        beam_toks[:, :, col + 1] = tok2
        if has_eos:
            finished = torch.gather(finished, 1, src) | (tok2 == eos)
        # each surviving beam's cache row, from the post-write caches
        rows = (base + src).reshape(B * k)
        caches = [(select_rows(kc, rows), select_rows(vc, rows))
                  for kc, vc in caches]
    return torch.cat([ids, beam_toks[:, 0, :]], dim=1)


def _decode_ids(net, ids, max_new, do_sample, top_k, top_p, eos, inv_t,
                noise, cache_dtype):
    """The greedy or sampled decode body (the JAX ``_decode_ids``,
    ``generation.py:187``): the prefill, then ``max_new - 1`` decode
    steps. ``eos`` is None, an int or a 0-d device tensor; ``inv_t`` the
    temperature's fp32 reciprocal (a float or a 0-d device tensor);
    ``noise(t)`` gives the ``[B, V]`` Gumbel noise of the token landing
    at position ``S + t`` (``sampling_keys.gumbel_noise``). Rows that
    emitted EOS keep emitting it."""
    B, S = int(ids.shape[0]), int(ids.shape[1])
    caches = alloc_kv_caches(net.config, B, S + max_new, cache_dtype,
                             device=ids.device)

    def select(logits, t):
        if not do_sample:
            return torch.argmax(logits, dim=-1)
        scaled = _filter_scaled(logits.float() * inv_t, top_k, top_p)
        return torch.argmax(scaled + noise(t), dim=-1)

    logits, caches = prefill(net, ids, caches)
    nxt = select(logits, 0)
    finished = (nxt == eos) if eos is not None else None
    out = [nxt]
    for i in range(1, max_new):
        logits, caches = decode_step(net, nxt[:, None], caches, S + i - 1)
        nxt = select(logits, i)
        if finished is not None:
            nxt = torch.where(finished, eos, nxt)
            finished = finished | (nxt == eos)
        out.append(nxt)
    return torch.cat([ids, torch.stack(out, dim=1)], dim=1)


def signature(B, S, max_new_tokens, do_sample, top_k, top_p, eos_token_id,
              num_beams, cache_dtype):
    """JAX's program key (``generation.py:456-466``): beam search
    normalizes the sampling knobs out."""
    if num_beams > 1:
        return (B, S, int(max_new_tokens), False, 0, 1.0,
                eos_token_id is not None, int(num_beams), cache_dtype)
    return (B, S, int(max_new_tokens), bool(do_sample), int(top_k),
            float(top_p) if top_p is not None else 1.0,
            eos_token_id is not None, 1, cache_dtype)


class _ProgramCache(dict):
    """``net._generate_cache``: sig -> :class:`_GenerateProgram`, with the
    net's graph memory pool and its count of captures. A copy of the net
    (``quantize_for_serving``, ``copy.deepcopy``) starts empty: graphs
    cannot be copied, and a copy's weights live elsewhere."""

    def __init__(self):
        super().__init__()
        self.pool = None
        self.captures = 0

    def __reduce__(self):
        return (_ProgramCache, ())

    def __deepcopy__(self, memo):
        return _ProgramCache()


def _weight_tensors(net):
    return tuple(net.state_dict(keep_vars=True).values())


class _GenerateProgram:
    """One signature's program: the :class:`~..serving.programs.Program`
    over static ids, reciprocal temperature, EOS id and (sampling)
    Gumbel noise; and the weights' addresses and ``net.fusions`` at
    capture."""

    def __init__(self, net, sig, pool):
        from ..serving.programs import Program, capture_stream

        B, S, max_new, do_sample, top_k, top_p, has_eos, k, cache_dtype = sig
        dev = net.device
        V = net.config.vocab_size
        inputs = [torch.zeros((B, S), dtype=torch.long, device=dev),
                  torch.zeros((), dtype=torch.float32, device=dev),
                  torch.zeros((), dtype=torch.long, device=dev)]
        if do_sample:
            inputs.append(torch.zeros((max_new, B, V), dtype=torch.float32,
                                      device=dev))

        def body(ids, inv_t, eos, noise=None):
            eos = eos if has_eos else None
            if k > 1:
                return beam_search(net, ids, max_new, k, eos, cache_dtype)
            return _decode_ids(net, ids, max_new, do_sample, top_k, top_p,
                               eos, inv_t, lambda t: noise[t], cache_dtype)

        weights = _weight_tensors(net)
        self.ptrs = tuple(t.data_ptr() for t in weights)
        self.fusions = net.fusions
        cuda = dev.type == "cuda"
        self.program = Program(body, inputs, pool=pool,
                               stream=capture_stream(dev) if cuda else None,
                               keep=weights)

    def current(self, net):
        """Whether the program still reads ``net``'s weights and runs its
        fusions."""
        return (net.fusions == self.fusions and self.ptrs == tuple(
            t.data_ptr() for t in _weight_tensors(net)))

    def __call__(self, *arrays):
        return self.program(*arrays)


def generate_programs(net):
    """The net's program cache (``net._generate_cache``: JAX's ``sig`` ->
    program, ``.captures`` counting every capture), created empty."""
    cache = net.__dict__.get("_generate_cache")
    if cache is None:
        cache = net.__dict__["_generate_cache"] = _ProgramCache()
    return cache


def generate(net, input_ids, max_new_tokens=32, do_sample=False,
             temperature=1.0, top_k=0, top_p=1.0, eos_token_id=None,
             seed=0, num_beams=1, cache_dtype=None, graphs=True):
    """Greedy or top-k/top-p sampled decode; returns an int64 tensor
    ``[B, S + max_new_tokens]`` on the net's device. Rows that emitted
    ``eos_token_id`` keep emitting it. ``cache_dtype`` is the KV storage
    dtype (bf16 by default; ``"float32"`` for exact parity with the
    cache-free forward of an fp32 net; ``"int8"`` for the quantized
    cache). Sampled row ``b`` draws as the ``b``-th request of a serving
    engine seeded with ``seed`` would. ``num_beams > 1`` runs
    deterministic beam search (:func:`beam_search`) and returns each
    row's best beam; it refuses ``do_sample``. ``graphs`` (default True)
    runs the signature's program (the module docstring); False the eager
    loop."""
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    if num_beams > 1 and do_sample:
        raise ValueError(
            "num_beams > 1 is deterministic beam search; combine with "
            "do_sample=False (sampled beam search is not implemented)"
        )
    from ..serving.sampling_keys import SamplingKeySource, gumbel_noise

    dev = net.device
    ids = _as_ids(input_ids, dev)
    B, S = int(ids.shape[0]), int(ids.shape[1])
    max_new = int(max_new_tokens)
    cache_dtype = normalize_cache_dtype(cache_dtype)
    do_sample = bool(do_sample)
    keys = None
    if do_sample:
        src = SamplingKeySource(seed)
        keys = [src.next_request_key() for _ in range(B)]
    V = net.config.vocab_size
    with torch.inference_mode():
        if not graphs:
            if num_beams > 1:
                return beam_search(net, ids, max_new, num_beams,
                                   eos_token_id, cache_dtype)
            return _decode_ids(
                net, ids, max_new, do_sample, top_k, top_p, eos_token_id,
                inverse_temperature(temperature),
                lambda t: gumbel_noise([(k, S + t) for k in keys], V, dev),
                cache_dtype)
        sig = signature(B, S, max_new, do_sample, top_k, top_p,
                        eos_token_id, num_beams, cache_dtype)
        cache = generate_programs(net)
        prog = cache.get(sig)
        if prog is None or not prog.current(net):
            if cache.pool is None and dev.type == "cuda":
                cache.pool = torch.cuda.graph_pool_handle()
            prog = cache[sig] = _GenerateProgram(net, sig, cache.pool)
            cache.captures += 1
        arrays = [ids, torch.tensor(inverse_temperature(temperature)),
                  torch.tensor(-1 if eos_token_id is None
                               else int(eos_token_id))]
        if do_sample:
            arrays.append(torch.stack([
                gumbel_noise([(k, S + t) for k in keys], V, dev)
                for t in range(max_new)]))
        return prog(*arrays).clone()
