"""The functionals the Llama serving and training paths call.

Counterpart of the used parts of ``paddle_tpu/nn/functional/norm.py``
(``rms_norm``), ``nn/functional/attention.py``
(``scaled_dot_product_attention``), ``nn/functional/common.py``
(``linear``), ``nn/functional/loss.py`` (``cross_entropy``),
``incubate/nn/functional/__init__.py`` (``fused_rotary_position_embedding``,
``swiglu``) and the two fusions' tensor-level entries
(``kernels/fused_norm_matmul.py`` ``rms_norm_matmul_apply``,
``kernels/fused_rope_attention.py`` ``rope_attention_apply``). Layouts
follow paddle: attention tensors are ``[batch, seq, heads, head_dim]``
and Linear weights ``[in, out]``. Under
:func:`paddle_tpu_torch.amp.auto_cast` the inputs are cast where the
JAX package's dispatch hook casts them (``amp/auto_cast.py``), under the
same op names.
"""
from __future__ import annotations

import math

import torch

from ..amp import fp8 as _fp8
from ..amp import naninf as _naninf
from ..amp.auto_cast import amp_cast
from ..kernels import flash_attention as _flash
from ..kernels import fused_norm_matmul as _fnm
from ..kernels import fused_rope_attention as _fra
from ..kernels import rms_norm as _rms
from ..kernels import rope as _rope


def _not_ported(what):
    """What the port does not compute yet is refused, never computed
    another way."""
    raise NotImplementedError(
        f"{what} is not ported (ROADMAP.md queue A item 5)")


def linear(x, weight, bias=None, name=None):
    """``x @ weight`` with paddle's ``[in, out]`` weight, the reference's
    parameter list (``common.py:31``); a bias is refused (the Llama
    projections carry none). Inside an armed fp8 context (AMP O3,
    ``amp/fp8.py``) the product runs on fp8 operands, after the O1 cast,
    as JAX's ``_linear`` routes it (``common.py:17-27``)."""
    if bias is not None:
        _not_ported("linear's bias")
    x, weight = amp_cast("linear", x, weight)
    if _fp8.active():
        return _fp8.fp8_linear_value(x, weight, None)
    return torch.matmul(x, weight)


def rms_norm(x, weight=None, bias=None, epsilon=1e-6, begin_norm_axis=-1,
             name=None):
    """RMSNorm over the last axis, through the RMSNorm kernels on a CUDA
    tensor (the TPU path's ``rms_norm_fused``, dispatched as
    ``fused_rms_norm``: on neither AMP list, so it runs in the types it
    is given). The reference's parameter list (``norm.py:150``); no
    weight is a weight of ones (the same values: ``x * rstd * 1`` is
    exact); a bias, or a norm over more than the last axis, is
    refused."""
    if bias is not None:
        _not_ported("rms_norm's bias")
    if begin_norm_axis % x.dim() != x.dim() - 1:
        _not_ported(f"rms_norm over axes {begin_norm_axis}.. of a "
                    f"{x.dim()}-d input (only the last axis)")
    if weight is None:
        weight = torch.ones(int(x.shape[-1]), dtype=x.dtype, device=x.device)
    return _rms.rms_norm(x, weight, float(epsilon))


def rms_norm_matmul(x, weight, matmul_weight, epsilon=1e-6):
    """``rms_norm(x, weight) @ matmul_weight`` in one kernel on a CUDA
    tensor (``fused_norm_matmul.rms_norm_matmul_apply``, dispatched as
    ``rms_norm_matmul``: on neither AMP list, so under O1 it multiplies
    the fp32 residual stream by the fp32 weight, in fp32)."""
    x, weight, matmul_weight = amp_cast("rms_norm_matmul", x, weight,
                                        matmul_weight)
    return _fnm.rms_norm_matmul(x, weight, matmul_weight, float(epsilon))


def rope_attention(q, k, v, cos, sin, causal=True, scale=None):
    """Rotate q and k by the rope tables, then attention, in one kernel
    on a CUDA tensor (``fused_rope_attention.rope_attention_apply``,
    dispatched as ``rope_attention``: on neither AMP list, so the inputs
    run in the types they are given)."""
    q, k, v, cos, sin = amp_cast("rope_attention", q, k, v, cos, sin)
    return _fra.rope_attention_fused(q, k, v, cos, sin, causal=causal,
                                     scale=scale)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None):
    """Attention over ``[B, S, H, D]`` tensors (``attention.py:54-86``),
    with the reference's parameter list. Dropout (``dropout_p > 0`` while
    ``training``) is refused; outside training it is off, as there.

    Without ``attn_mask`` on a CUDA tensor it runs the flash attention
    kernels (the route the JAX package takes on its accelerator,
    ``attention.py:68-74``), with q, k and v aligned to their promoted
    dtype as ``flash_attention_fwd`` does. Otherwise, and on the CPU as
    in the JAX package, it is composed attention in plain PyTorch, in the
    op order of ``_sdpa_ref`` (``attention.py:21-42``): score product in
    the inputs' dtype, scale, causal mask aligned bottom-right (``tril``
    with ``k = sk - sq``), additive or boolean ``attn_mask``, fp32
    softmax cast back, value product."""
    if float(dropout_p) > 0.0 and training:
        _not_ported(f"dropout in scaled_dot_product_attention (dropout_p "
                    f"{dropout_p})")
    query, key, value, attn_mask = amp_cast(
        "scaled_dot_product_attention", query, key, value, attn_mask)
    scale = 1.0 / math.sqrt(int(query.shape[-1]))
    if attn_mask is None and query.device.type == "cuda":
        ct = torch.promote_types(torch.promote_types(query.dtype, key.dtype),
                                 value.dtype)
        query, key, value = (t.to(ct) for t in (query, key, value))
        return _flash.flash_attention(query, key, value, causal=is_causal,
                                      scale=scale)
    # one op for the NaN/Inf sweep, as JAX dispatches it (its masked
    # scores are -inf inside the op)
    return _naninf.kernel_op("scaled_dot_product_attention", _composed,
                             query, key, value, attn_mask, is_causal, scale)


def _composed(query, key, value, attn_mask, is_causal, scale):
    qt = query.transpose(1, 2)
    kt = key.transpose(1, 2)
    vt = value.transpose(1, 2)
    s = torch.matmul(qt, kt.transpose(-1, -2)) * scale
    if is_causal:
        sq, sk = int(s.shape[-2]), int(s.shape[-1])
        keep = torch.ones((sq, sk), dtype=torch.bool,
                          device=s.device).tril(sk - sq)
        s = s.masked_fill(~keep, float("-inf"))
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            s = s.masked_fill(~attn_mask, float("-inf"))
        else:
            s = s + attn_mask
    p = torch.softmax(s.float(), dim=-1).to(query.dtype)
    return torch.matmul(p, vt).transpose(1, 2)


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style=True,
                                    time_major=False,
                                    rotary_emb_base=10000.0):
    """paddle.incubate.nn.functional.fused_rotary_position_embedding
    (neox style). ``sin``/``cos``: ``[1, S, 1, D/2]`` half tables,
    ``[.., D]`` full tables (two mirrored halves), or None to build them
    from ``rotary_emb_base``. ``position_ids`` [B, S] pick each token's
    table row. q and k go through the rope kernel in one launch; v in
    another. Returns ``(q, k, v)``."""
    if time_major:
        raise NotImplementedError("time_major=True is not supported")
    if not use_neox_rotary_style:
        raise NotImplementedError(
            "the GPT-J interleaved rotation is not ported; the Llama "
            "path uses the neox style"
        )
    lead = q if q is not None else (k if k is not None else v)
    if lead is None:
        return None, None, None
    s_len, d = int(lead.shape[1]), int(lead.shape[3])
    if cos is None or sin is None:
        cos_h, sin_h = _rope.build_rope_cache(
            s_len, d, base=rotary_emb_base, device=lead.device)
    else:
        cos_h = cos.reshape(1, -1, 1, cos.shape[-1])
        sin_h = sin.reshape(1, -1, 1, sin.shape[-1])
        if int(cos_h.shape[-1]) == d:  # full-dim tables: mirrored halves
            cos_h, sin_h = cos_h[..., : d // 2], sin_h[..., : d // 2]
    q_out = k_out = None
    if q is not None:
        q_out, k_out = _rope.rope_fused(q, k, cos_h, sin_h, position_ids)
    elif k is not None:
        k_out = _rope.rope_fused(k, None, cos_h, sin_h, position_ids)[0]
    v_out = None if v is None else _rope.rope_fused(
        v, None, cos_h, sin_h, position_ids)[0]
    return q_out, k_out, v_out


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Cross entropy with the reference's parameter list (``loss.py:73``;
    ``_cross_entropy`` ``:26-70``): log-softmax over ``axis`` in the
    input's dtype (fp32 under AMP, where the op is black-listed), or the
    log of the input clamped at 1e-30 without ``use_softmax``.

    Soft labels (``soft_label``, or a label of the input's shape): the
    loss is ``-sum(soft * logp)`` over the classes, ``soft`` mixed with
    ``1 / classes`` by ``label_smoothing``; a class ``weight`` scales each
    row by ``sum(soft * weight)``; ``mean`` is the plain mean. Hard
    labels: the label's entry picked, mixed with the mean over classes by
    ``label_smoothing``, times ``weight[label]``, zero at
    ``ignore_index``; ``mean`` divides by the kept labels' summed weight,
    or without a weight by their count (at least 1)."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"reduction must be 'mean', 'sum' or 'none', got "
                         f"{reduction!r}")
    input, label, weight = amp_cast("cross_entropy", input, label, weight)
    ax = axis % input.dim()
    if use_softmax:
        logp = torch.log_softmax(input, dim=ax)
    else:
        logp = torch.log(torch.clamp_min(input, 1e-30))
    n_classes = int(input.shape[ax])
    wshape = (1,) * ax + (-1,) + (1,) * (input.dim() - ax - 1)
    if soft_label or tuple(label.shape) == tuple(input.shape):
        soft = label
        if label_smoothing > 0:
            soft = soft * (1 - label_smoothing) + label_smoothing / n_classes
        loss = -torch.sum(soft * logp, dim=ax)
        if weight is not None:
            loss = loss * torch.sum(soft * weight.reshape(wshape), dim=ax)
        if reduction == "mean":
            return loss.mean()
        return loss.sum() if reduction == "sum" else loss
    if label.dtype.is_floating_point:
        raise TypeError(f"cross_entropy: a hard label must be an integer "
                        f"tensor, got {label.dtype} (soft labels take "
                        f"soft_label=True)")
    lbl = label
    if lbl.dim() == input.dim() and int(lbl.shape[ax]) == 1:
        lbl = lbl.squeeze(ax)
    if lbl.dim() != input.dim() - 1:
        raise ValueError(
            f"hard label expected ndim {input.dim() - 1} (or {input.dim()} "
            f"with size 1 on the class axis), got label shape "
            f"{tuple(label.shape)} for input shape {tuple(input.shape)}"
        )
    lbl = lbl.long()
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, torch.zeros_like(lbl))
    loss = -torch.gather(logp, ax, safe.unsqueeze(ax)).squeeze(ax)
    if label_smoothing > 0:
        loss = (1 - label_smoothing) * loss \
            + label_smoothing * -logp.mean(dim=ax)
    if weight is not None:
        w = weight[safe]
        loss = loss * w
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    if reduction == "mean":
        if weight is not None:
            return loss.sum() / torch.where(valid, w,
                                            torch.zeros_like(w)).sum()
        return loss.sum() / valid.sum().to(loss.dtype).clamp_min(1.0)
    if reduction == "sum":
        return loss.sum()
    return loss


def swiglu(x, y=None):
    """silu(x) * y; with ``y`` None, ``x`` splits in half on the last
    axis (the fused gate+up projection)."""
    if y is None:
        x, y = torch.chunk(x, 2, dim=-1)
    return torch.nn.functional.silu(x) * y
