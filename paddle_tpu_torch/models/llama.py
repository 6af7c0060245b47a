"""Llama-family decoder in PyTorch (counterpart of
``paddle_tpu/models/llama.py``).

Same structure, parameter names and ``[in, out]`` Linear layout as the
JAX model, so a state dict crosses between the packages unchanged
(``paddle_tpu_torch.convert``). On a CUDA device:

- the three RMSNorms per layer stack (two per layer and the final one)
  run the RMSNorm kernel (``kernels/rms_norm.py``);
- q and k rotate through the rope kernel in one launch per layer
  (``kernels/rope.py``), with per-row position ids looked up inside it;
- the paged decode step attends through the paged attention kernel
  (``kernels/paged_attention.py``), its int8 flavour over an int8
  (``QuantizedKV``) arena;
- the cache-free forward without a mask (training, and the serving
  checks' reference) attends through the flash attention kernels
  (``kernels/flash_attention.py``), as the JAX model does on its
  accelerator;
- prefill and the slab decode step attend through the composed masked
  attention (plain PyTorch, the op order of the JAX ``_sdpa_ref``), as
  the JAX model does whenever a mask is given; an int8 slab cache
  dequantizes to the compute dtype on read;
- the projections and the head are ``torch.matmul``, the plain products
  XLA ran, or, after ``quantization.quantize_for_serving``, the W8A16
  kernel (``kernels/int8_matmul.py``) of each ``QuantizedLinear``.

The RMSNorm, rope and flash attention kernels have backward kernels
(``torch.autograd.Function``), so the cache-free forward carries
gradients; :func:`causal_lm_loss` is the training loss.

Caches, float or int8, are written in place (see
``quantization/kv.py``). The tune-cache opt-ins of the JAX model (the
fused rope+attention and the fused norm+head) are not ported: they have
no measured entries there either, and a quantized head has no fused
norm+head at all (``llama.py:434-448``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..device import resolve_device
from ..kernels.paged_attention import paged_attention
from ..kernels.rope import build_rope_cache
from ..nn import Embedding, Linear, RMSNorm
from ..nn import functional as F
from ..quantization import kv as qkv


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int | None = None  # GQA; None -> MHA
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads

    @property
    def kv_heads(self):
        return self.num_key_value_heads or self.num_attention_heads

    @staticmethod
    def tiny(**kw):
        base = dict(
            vocab_size=1000, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            max_position_embeddings=128,
        )
        base.update(kw)
        return LlamaConfig(**base)

    @staticmethod
    def llama2_7b(**kw):
        base = dict(
            vocab_size=32000, hidden_size=4096, intermediate_size=11008,
            num_hidden_layers=32, num_attention_heads=32,
            max_position_embeddings=4096,
        )
        base.update(kw)
        return LlamaConfig(**base)


def causal_lm_loss(logits, labels, ignore_index=-100):
    """Per-token cross entropy over the flattened ``[..., V]`` logits,
    zero at ``ignore_index`` labels; the caller owns the reduction
    (``paddle_tpu/models/llama.py:72``, its single-device branch)."""
    v = int(logits.shape[-1])
    return F.cross_entropy(logits.reshape(-1, v), labels.reshape(-1),
                           ignore_index=ignore_index, reduction="none")


def _is_row_vector(pos):
    return isinstance(pos, torch.Tensor) and pos.dim() == 1


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.cfg = config
        h, d = config.hidden_size, config.head_dim
        kw = dict(device=device, dtype=dtype)
        self.q_proj = Linear(h, config.num_attention_heads * d, **kw)
        self.k_proj = Linear(h, config.kv_heads * d, **kw)
        self.v_proj = Linear(h, config.kv_heads * d, **kw)
        self.o_proj = Linear(config.num_attention_heads * d, h, **kw)

    def _repeat_kv(self, k, v):
        cfg = self.cfg
        if cfg.kv_heads != cfg.num_attention_heads:
            rep = cfg.num_attention_heads // cfg.kv_heads
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        return k, v

    def forward(self, x, rope_cos=None, rope_sin=None, attn_mask=None,
                cache=None, pos=None, page_table=None):
        """Cache-free when ``cache`` is None. With ``cache=(k, v)``
        ([B, S_max, kvH, D] each) and ``pos`` (an int: tokens already
        cached, or an int [B] tensor: every row at its own depth), the
        new k/v are written in place at [pos, pos + S) and attention
        runs over the cache behind a position mask; returns
        ``(out, cache)``. With ``page_table`` ([B, P] int32) the cache
        pair is a page arena ([num_pages, page_size, kvH, D] each), S is
        1, and attention runs through the paged attention kernel."""
        cfg = self.cfg
        B, S = int(x.shape[0]), int(x.shape[1])
        if page_table is not None and cache is None:
            raise ValueError("page_table requires a page-arena cache")
        q = self.q_proj(x).reshape(B, S, cfg.num_attention_heads,
                                   cfg.head_dim)
        k = self.k_proj(x).reshape(B, S, cfg.kv_heads, cfg.head_dim)
        v = self.v_proj(x).reshape(B, S, cfg.kv_heads, cfg.head_dim)
        pos_ids = None
        if cache is not None and _is_row_vector(pos):
            # per-row decode depths: the rope kernel reads each row's
            # table row by id
            pos_ids = pos.to(torch.int32)[:, None] + torch.arange(
                S, dtype=torch.int32, device=x.device)[None, :]
        q, k, _ = F.fused_rotary_position_embedding(
            q, k, None, sin=rope_sin, cos=rope_cos, position_ids=pos_ids,
            rotary_emb_base=cfg.rope_theta,
        )
        if page_table is not None:
            return self._paged(q, k, v, cache, pos, page_table, attn_mask)
        if cache is not None:
            return self._slab(q, k, v, cache, pos, attn_mask)
        k, v = self._repeat_kv(k, v)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, is_causal=attn_mask is None)
        return self.o_proj(out.reshape(B, S, -1))

    def _paged(self, q, k, v, cache, pos, page_table, attn_mask):
        B, S = int(q.shape[0]), int(q.shape[1])
        if S != 1:
            raise ValueError(
                f"paged decode feeds one token per row (S == 1), got S={S}"
            )
        if attn_mask is not None:
            raise ValueError(
                "the paged decode step masks by position only; an explicit "
                "attn_mask is not supported there"
            )
        k_pages, v_pages = cache
        ps = int(k_pages.shape[1])
        p = pos.to(torch.int32)
        tbl = page_table.to(torch.int32)
        # this step's k/v land at each row's (page, offset); free rows
        # write the garbage page 0
        pp = torch.gather(tbl, 1, (p // ps).long()[:, None])[:, 0]
        po = p % ps
        qkv.write_paged(k_pages, k[:, 0], pp, po)
        qkv.write_paged(v_pages, v[:, 0], pp, po)
        out = paged_attention(q.contiguous(), k_pages, v_pages,
                              tbl.contiguous(), p.contiguous())
        return self.o_proj(out.reshape(B, S, -1)), (k_pages, v_pages)

    def _slab(self, q, k, v, cache, pos, attn_mask):
        B, S = int(q.shape[0]), int(q.shape[1])
        k_cache, v_cache = cache
        s_max = int(k_cache.shape[1])
        dev = q.device
        if _is_row_vector(pos):
            # per-row positions [B] (continuous batching): scatter at
            # every row's own offset
            rows = torch.arange(B, device=dev)[:, None]
            cols = pos.long()[:, None] + torch.arange(S, device=dev)[None, :]
            qkv.write_at_rows(k_cache, k, rows, cols)
            qkv.write_at_rows(v_cache, v, rows, cols)
            valid = (torch.arange(s_max, device=dev)[None, None, :]
                     <= cols[:, :, None])                   # [B, S, S_max]
            valid = valid[:, None]
        else:
            p = int(pos)
            qkv.write_at_pos(k_cache, k, p)
            qkv.write_at_pos(v_cache, v, p)
            # token (p + t) may read cache slot s iff s <= p + t
            valid = (torch.arange(s_max, device=dev)[None, :]
                     <= (p + torch.arange(S, device=dev))[:, None])
            valid = valid[None, None]
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        mask = torch.where(valid, zero, float("-inf"))
        if attn_mask is not None:
            mask = mask + attn_mask
        kk = qkv.read_dense(k_cache, q.dtype)
        vv = qkv.read_dense(v_cache, q.dtype)
        kk, vv = self._repeat_kv(kk, vv)
        out = F.scaled_dot_product_attention(q, kk.to(q.dtype),
                                             vv.to(q.dtype), attn_mask=mask)
        return self.o_proj(out.reshape(B, S, -1)), (k_cache, v_cache)


class LlamaMLP(nn.Module):
    def __init__(self, config: LlamaConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        h, ffn = config.hidden_size, config.intermediate_size
        # gate+up as ONE product; swiglu splits it
        self.gate_up_proj = Linear(h, 2 * ffn, device=device, dtype=dtype)
        self.down_proj = Linear(ffn, h, device=device, dtype=dtype)

    def forward(self, x):
        return self.down_proj(F.swiglu(self.gate_up_proj(x)))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.input_layernorm = RMSNorm(config.hidden_size,
                                       epsilon=config.rms_norm_eps, **kw)
        self.self_attn = LlamaAttention(config, **kw)
        self.post_attention_layernorm = RMSNorm(
            config.hidden_size, epsilon=config.rms_norm_eps, **kw)
        self.mlp = LlamaMLP(config, **kw)

    def forward(self, x, rope_cos=None, rope_sin=None, attn_mask=None,
                cache=None, pos=None, page_table=None):
        if cache is not None:
            a, new_cache = self.self_attn(
                self.input_layernorm(x), rope_cos, rope_sin, attn_mask,
                cache=cache, pos=pos, page_table=page_table,
            )
            h = x + a
            return h + self.mlp(self.post_attention_layernorm(h)), new_cache
        h = x + self.self_attn(self.input_layernorm(x), rope_cos, rope_sin,
                               attn_mask)
        return h + self.mlp(self.post_attention_layernorm(h))


class LlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.config = config
        self.embed_tokens = Embedding(config.vocab_size, config.hidden_size,
                                      **kw)
        self.layers = nn.ModuleList(
            [LlamaDecoderLayer(config, **kw)
             for _ in range(config.num_hidden_layers)]
        )
        self.norm = RMSNorm(config.hidden_size, epsilon=config.rms_norm_eps,
                            **kw)
        self._rope = {}

    def rope_tables(self, seq_len, device):
        """fp32 cos/sin ``[1, seq_len, 1, D/2]``: the leading rows of one
        table per device (row t depends only on t), built for at least
        ``max_position_embeddings`` rows and rebuilt only when a longer
        one is asked for."""
        tabs = self._rope.get(str(device))
        if tabs is None or int(tabs[0].shape[1]) < seq_len:
            n = max(int(seq_len), self.config.max_position_embeddings)
            tabs = self._rope[str(device)] = build_rope_cache(
                n, self.config.head_dim, base=self.config.rope_theta,
                device=device)
        return tabs[0][:, :seq_len], tabs[1][:, :seq_len]

    def forward(self, input_ids, attn_mask=None, caches=None, pos=None,
                apply_final_norm=True, page_table=None, exit_layer=None):
        """``caches``: per-layer (k, v) caches for prefill/decode
        (returns ``(hidden, caches)``), None for the cache-free forward.
        With ``page_table`` the caches are per-layer page arenas.
        ``apply_final_norm=False`` returns the pre-norm hidden state;
        ``exit_layer=N`` runs only the first N decoder layers."""
        S = int(input_ids.shape[1])
        dev = input_ids.device
        layers = (list(self.layers) if exit_layer is None
                  else list(self.layers)[:int(exit_layer)])
        h = self.embed_tokens(input_ids)
        if caches is None:
            cos, sin = self.rope_tables(S, dev)
            for layer in layers:
                h = layer(h, cos, sin, attn_mask)
            return self.norm(h) if apply_final_norm else h
        if page_table is not None:
            # the rope table covers every addressable position
            s_max = int(page_table.shape[1]) * int(caches[0][0].shape[1])
        else:
            s_max = int(caches[0][0].shape[1])
        cos, sin = self.rope_tables(s_max, dev)
        if not _is_row_vector(pos):
            p = int(pos)  # rope rows for the tokens being fed: [p, p + S)
            cos, sin = cos[:, p:p + S], sin[:, p:p + S]
        new_caches = []
        for layer, cache in zip(layers, caches):
            h, c2 = layer(h, cos, sin, attn_mask, cache=cache, pos=pos,
                          page_table=page_table)
            new_caches.append(c2)
        return (self.norm(h) if apply_final_norm else h), new_caches


class LlamaForCausalLM(nn.Module):
    """Llama causal LM. ``device`` defaults to the first CUDA card (and
    raises without one); pass ``device="cpu"`` for the plain path.
    Weights are drawn from a ``torch.Generator`` on the device seeded
    with ``seed``."""

    def __init__(self, config: LlamaConfig, *, device=None,
                 dtype=torch.float32, seed=0):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.model = LlamaModel(config, device=device, dtype=dtype)
        self.lm_head = None if config.tie_word_embeddings else Linear(
            config.hidden_size, config.vocab_size, device=device,
            dtype=dtype)
        self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed=0):
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        for mod in self.modules():
            if mod is not self and hasattr(mod, "reset_parameters"):
                mod.reset_parameters(gen)

    @property
    def device(self):
        return self.model.embed_tokens.weight.device

    @property
    def dtype(self):
        return self.model.embed_tokens.weight.dtype

    def num_params(self):
        return sum(p.numel() for p in self.parameters())

    def flops_per_token(self, seq_len):
        """Training FLOPs per token: 6 * params plus the attention term
        12 * layers * hidden * seq_len (``LlamaFlopsMixin``,
        ``paddle_tpu/models/llama.py:405-419``)."""
        cfg = self.config
        return (6 * self.num_params()
                + 12 * cfg.num_hidden_layers * cfg.hidden_size * seq_len)

    def _head(self, h):
        if self.lm_head is None:
            return F.linear(h, self.model.embed_tokens.weight.t())
        return self.lm_head(h)

    def forward(self, input_ids, attn_mask=None, caches=None, pos=None,
                page_table=None, exit_layer=None):
        if caches is not None:
            h, new_caches = self.model(
                input_ids, attn_mask, caches=caches, pos=pos,
                page_table=page_table, exit_layer=exit_layer,
            )
            return self._head(h), new_caches
        return self._head(self.model(input_ids, attn_mask,
                                     exit_layer=exit_layer))

    def generate(self, input_ids, max_new_tokens=32, do_sample=False,
                 temperature=1.0, top_k=0, top_p=1.0, eos_token_id=None,
                 seed=0, num_beams=1, cache_dtype=None):
        from .generation import generate as _generate

        return _generate(
            self, input_ids, max_new_tokens=max_new_tokens,
            do_sample=do_sample, temperature=temperature, top_k=top_k,
            top_p=top_p, num_beams=num_beams, eos_token_id=eos_token_id,
            seed=seed, cache_dtype=cache_dtype,
        )
