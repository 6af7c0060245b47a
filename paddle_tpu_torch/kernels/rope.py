"""Rotary position embedding (neox half-split): the hand-written Hopper
kernel, its plain version, and the rope tables.

Counterpart of ``paddle_tpu/kernels/rope.py`` (``rope_fused``, a
``jax.custom_vjp``; the TPU kernel is ``_rope_kernel``, launched from
``_rope_apply``, and the backward ``_rope_bwd`` is the same kernel with
-sin) and of ``build_rope_cache``. The CUDA source is
``paddle_tpu_torch/csrc/rope.cu``. It rotates q and k in one launch, and
takes position ids itself: with ``position_ids`` the table rows are
looked up in the kernel instead of being gathered first (the same
function with one tensor fewer). Its backward entry point flips the sign
of sin in registers, so no negated table is ever built. The kernel reads
each half of a row in 16-byte vectors; at a head dim whose half is not a
multiple of the vector (bf16 72, say), the wrapper pads each half into
a copy (:func:`pad_halves`, the tables with zero columns) and slices the
output back, so the pairing of column c with c + D/2 is the true one.

:func:`rope_fused` is a ``torch.autograd.Function`` that routes on the
device in both directions: CPU tensors go to :func:`rope_reference` (and
:func:`rope_backward_reference`), CUDA tensors to the kernel, which
launches or raises.
"""
from __future__ import annotations

import torch

from ..amp import naninf as _naninf
from . import _build

# kernel launches made by this process: forward and backward entry points
launches = 0
bwd_launches = 0
# of those, the launches over fp16 tensors
fp16_launches = 0
fp16_bwd_launches = 0


def build_rope_cache(seq_len, head_dim, base=10000.0, dtype=torch.float32,
                     device=None):
    """cos/sin tables ``[1, S, 1, D/2]`` (paddle/llama convention), in
    the op order of ``rope.py:94-102``."""
    inv = 1.0 / (base ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                       device=device) / head_dim))
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv)
    return (torch.cos(freqs)[None, :, None, :].to(dtype),
            torch.sin(freqs)[None, :, None, :].to(dtype))


def pad_halves(x, half):
    """``[..., D]`` -> ``[..., 2 half]``: each half zero-padded to
    ``half`` columns (``[x1, 0, x2, 0]``), so that column c still pairs
    with c + half (a zero pair rotates to zero)."""
    h2 = int(x.shape[-1]) // 2
    if h2 == half:
        return x
    z = x.new_zeros(tuple(x.shape[:-1]) + (half - h2,))
    return torch.cat([x[..., :h2], z, x[..., h2:], z], dim=-1)


def unpad_halves(x, h2):
    """The inverse of :func:`pad_halves`: the first ``h2`` columns of each
    half."""
    half = int(x.shape[-1]) // 2
    if h2 == half:
        return x
    return torch.cat([x[..., :h2], x[..., half:half + h2]], dim=-1)


def _table_rows(cos, sin, position_ids):
    """The fp32 ``[1 or B, S, 1, D/2]`` rows one rotation reads."""
    cos, sin = cos.float(), sin.float()
    if position_ids is None:
        return cos, sin
    idx = position_ids.long()
    return cos[0, :, 0, :][idx][:, :, None, :], \
        sin[0, :, 0, :][idx][:, :, None, :]


def rope_reference(x, cos, sin, position_ids=None):
    """Plain PyTorch neox rotation in fp32, cast back to x's type.
    ``x`` [B, S, H, D]; ``cos``/``sin`` [1 or B, S, 1, D/2]; with
    ``position_ids`` [B, S] the tables are ``[1, rows, 1, D/2]`` and row
    ``position_ids[b, s]`` rotates token (b, s)."""
    c, s = _table_rows(cos, sin, position_ids)
    half = int(x.shape[-1]) // 2
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    o1 = x1 * c - x2 * s
    o2 = x2 * c + x1 * s
    return torch.cat([o1, o2], dim=-1).to(x.dtype)


def rope_backward_reference(g, cos, sin, position_ids=None):
    """Plain PyTorch backward: the gradient rotated by -theta
    (``rope.py:85-88``)."""
    return rope_reference(g, cos, -sin, position_ids)


def _rotate(q, k, cos, sin, position_ids, inverse):
    if q.device.type == "cpu":
        fn = rope_backward_reference if inverse else rope_reference
        return (fn(q, cos, sin, position_ids),
                None if k is None else fn(k, cos, sin, position_ids))
    return rope_cuda(q, k, cos, sin, position_ids, inverse=inverse)


class _Rope(torch.autograd.Function):
    """Outputs ``q_out`` alone when k is None, else ``(q_out, k_out)``;
    the tables and ids take no gradient."""

    @staticmethod
    def forward(ctx, q, k, cos, sin, position_ids):
        q_out, k_out = _naninf.kernel_op("fused_rope", _rotate, q, k, cos,
                                         sin, position_ids, False)
        ctx.save_for_backward(cos, sin, position_ids)
        ctx.has_k = k is not None
        return q_out if k is None else (q_out, k_out)

    @staticmethod
    def backward(ctx, gq, gk=None):
        # an unused output's gradient arrives as zeros (materialized)
        cos, sin, position_ids = ctx.saved_tensors
        dq, dk = _naninf.kernel_op(
            "fused_rope", _rotate, gq.contiguous(),
            gk.contiguous() if ctx.has_k else None, cos, sin, position_ids,
            True)
        return dq, dk, None, None, None


def rope_fused(q, k, cos, sin, position_ids=None):
    """Rotate ``q`` and (when not None) ``k``; returns ``(q_out, k_out)``.
    Shapes as in :func:`rope_reference`; q and k may differ in heads.
    Differentiable in q and k."""
    out = _Rope.apply(q, k, cos, sin, position_ids)
    return (out, None) if k is None else out


def _check_x(x, name, dtype, b, s, d):
    if x.dim() != 4 or tuple(x.shape[:2]) != (b, s) or x.shape[3] != d:
        raise ValueError(
            f"rope: {name} must be [{b}, {s}, H, {d}], got {tuple(x.shape)}"
        )
    if x.dtype != dtype:
        raise TypeError(f"rope: q and k dtypes differ ({dtype}, {x.dtype})")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"rope: {name} must be contiguous, 16-byte aligned")


def rope_cuda(q, k, cos, sin, position_ids=None, inverse=False):
    """Launch ``csrc/rope.cu`` over q (and k) in one go; with ``inverse``
    the backward entry point (rotation by -theta)."""
    global launches, bwd_launches, fp16_launches, fp16_bwd_launches
    dev = q.device
    for t in (k, cos, sin, position_ids):
        if t is not None and t.device != dev:
            raise ValueError(
                f"rope kernel needs every input on {dev}, got {t.device}"
            )
    if dev.type != "cuda":
        raise ValueError(f"rope kernel needs CUDA tensors, got {dev}")
    if q.dtype not in _build.FLOAT_TYPES:
        raise TypeError(f"rope kernel takes float32/bfloat16/float16, got "
                        f"{q.dtype}")
    b, s, _, d = (int(v) for v in q.shape)
    if d % 2:
        raise ValueError(f"rope needs an even head_dim, got {d}")
    _check_x(q, "q", q.dtype, b, s, d)
    if k is not None:
        _check_x(k, "k", q.dtype, b, s, d)
    # each half is read in 16-byte vectors: pad it to a whole number
    vec = 16 // q.element_size()
    h2 = d // 2
    hp = -(-h2 // vec) * vec
    if hp != h2:
        q, k = (None if t is None else pad_halves(t, hp) for t in (q, k))
        cos, sin = (torch.nn.functional.pad(t.float(), (0, hp - h2))
                    for t in (cos, sin))
        d = 2 * hp
    cos, sin = (t.float().contiguous() for t in (cos, sin))
    # the kernel reads the tables in 16-byte vectors
    cos, sin = (t.clone() if t.data_ptr() % 16 else t for t in (cos, sin))
    if cos.dim() != 4 or cos.shape != sin.shape or cos.shape[2] != 1 \
            or cos.shape[3] != d // 2:
        raise ValueError(
            f"rope: cos/sin must be [1 or B, rows, 1, {d // 2}], got "
            f"{tuple(cos.shape)} and {tuple(sin.shape)}"
        )
    tab_b, tab_rows = int(cos.shape[0]), int(cos.shape[1])
    if position_ids is not None:
        if tuple(position_ids.shape) != (b, s):
            raise ValueError(
                f"rope: position_ids must be [{b}, {s}], got "
                f"{tuple(position_ids.shape)}"
            )
        if tab_b != 1:
            raise ValueError("rope: position_ids index a shared [1, ...] "
                             "table")
        position_ids = position_ids.to(torch.int32).contiguous()
    else:
        if tab_b not in (1, b) or tab_rows != s:
            raise ValueError(
                f"rope: without position_ids the tables must be "
                f"[1 or {b}, {s}, 1, {d // 2}], got {tuple(cos.shape)}"
            )
    lib = _build.load()
    q_out = torch.empty_like(q)
    k_out = None if k is None else torch.empty_like(k)
    null = None
    name = "ptt_rope_bwd" if inverse else "ptt_rope_fwd"
    with torch.cuda.device(dev):
        err = getattr(lib, name)(
            _build.ptr(q), _build.ptr(q_out), int(q.shape[2]),
            null if k is None else _build.ptr(k),
            null if k is None else _build.ptr(k_out),
            0 if k is None else int(k.shape[2]),
            _build.ptr(cos), _build.ptr(sin),
            null if position_ids is None else _build.ptr(position_ids),
            b, s, d, tab_b, tab_rows, _build.DTYPE_CODES[q.dtype],
            _build.stream_of(q),
        )
    _build.check(err, name)
    if inverse:
        bwd_launches += 1
        fp16_bwd_launches += q.dtype == torch.float16
    else:
        launches += 1
        fp16_launches += q.dtype == torch.float16
    if hp != h2:
        q_out, k_out = (None if t is None else unpad_halves(t, h2)
                        for t in (q_out, k_out))
    return q_out, k_out
