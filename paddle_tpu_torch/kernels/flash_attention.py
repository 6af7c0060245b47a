"""Flash attention, forward and backward: the hand-written Hopper kernels
and their plain versions.

Counterpart of ``paddle_tpu/kernels/flash_attention.py``
(``flash_attention_fwd``), which on a TPU runs jax's stock Pallas flash
attention (``_pallas_fa``): one forward and two backward kernels (dK/dV
and dQ). The CUDA source is ``paddle_tpu_torch/csrc/flash_attention.cu``;
its header says what bounds it on the H100 and how the designs answer
that.

Two designs, chosen by dtype and head dim (:func:`design`). The
tensor-core design (``"tc"``: wgmma products with fp32 accumulators, TMA
tile loads) runs every head dim in every dtype: bf16 and fp16 at their
padded width, at least 64 (the tensor-core tiles' 64-column unit; zero
columns add exact zeros to every fp32 sum; fp16's backward up to 128,
above it a ``TypeError`` naming ROADMAP.md queue B); fp32 through split
products, each
fp32 operand written as three bf16 parts (hi, mid, lo, which keep its 24
significant bits) and each product as the six bf16 products of parts
whose terms are larger than about 2^-22 of it, so the result keeps the
fp32 contract (1e-5 of the largest entry against the plain version); the
parts go to a bf16 workspace by a pre-pass (at width 64, 128 or 256:
:func:`split_width`). Above 128 an fp32 call runs each kernel as a pair
of CTAs (a cluster), each holding the parts of one half of the head dim
and trading its partial scores with the other through distributed shared
memory: three parts of a 64-row tile at 256 columns take 96 KB, so no
single CTA holds the tiles it needs (the source's header).
``cuda_cores=True`` runs the CUDA-core kernels (``"cc"``: fp32 FMAs) at
any head dim and dtype: the design the tensor-core kernels replaced,
kept to compare with. Each design counts its own launches beside the
totals. Every head dim up to 256 runs: one that is not a multiple of 16
is zero-padded into a copy up to the next multiple (:func:`pad_head_dim`;
the softmax scale stays 1/sqrt of the true head dim), and the outputs
and gradients are sliced back; a kernel is built at the next of 64, 128
and 256 (the CUDA-core ones also 16 and 32) and masks the columns past
its width (D 80 runs the 128-wide kernels). A head dim above 256 is
refused (ROADMAP.md queue C item 1).

Shape contract (the paddle layout, as in the TPU module): q ``[B, Sq, H,
D]``, k and v ``[B, Sk, H, D]`` with equal head counts, read through
their strides (the last axis contiguous). Causal masking is aligned
bottom-right, ``tril(k = Sk - Sq)``, as the JAX package's composed path
(``_composed``) and the port's composed attention do; on ``Sq == Sk`` it
equals the stock kernel's top-left mask. A causal call needs ``Sk >=
Sq`` (every row then sees at least one key). The forward returns ``O``
in the inputs' dtype and the fp32 log-sum-exp ``LSE`` ``[B, H, Sq]``.

:func:`flash_attention` is a ``torch.autograd.Function``: CPU tensors
run :func:`flash_attention_reference` and
:func:`flash_attention_backward_reference` (plain PyTorch in the
kernels' math: fp32 scores, P from LSE, P and dS rounded to the inputs'
dtype before their second products, at the stock Pallas kernel's four
points), CUDA tensors launch the kernels or raise. The TPU module's size
policy (``_select``'s v5e thresholds) is not ported: a CUDA tensor
always runs a kernel. :func:`probability_rounding_slack` bounds what
rounding P and dS at other points (the bf16 kernel rounds unnormalised
P tile by tile) can move each output entry.
"""
from __future__ import annotations

import functools
import math

import torch

from ..amp import naninf as _naninf
from . import _build

# kernel launches made by this process: forward, and backward (one per
# backward call: its Delta, dK/dV and dQ passes); the same split by
# design: tensor cores ("tc") and CUDA cores ("cc"), as design() says
launches = 0
bwd_launches = 0
# of those, the launches over fp16 tensors
fp16_launches = 0
fp16_bwd_launches = 0
tc_launches = 0
tc_bwd_launches = 0
cc_launches = 0
cc_bwd_launches = 0
DESIGN_COUNTERS = ("tc_launches", "tc_bwd_launches", "cc_launches",
                   "cc_bwd_launches")
DESIGNS = {"tc": "wgmma", "cc": "cuda-core"}

# head dims the kernels take: any up to MAX_HEAD_DIM, run at the next
# multiple of HEAD_DIM_STEP; the tensor-core tiles are at least
# TC_MIN_HEAD_DIM wide (one 128-byte swizzle span of bf16)
HEAD_DIM_STEP, MAX_HEAD_DIM = 16, 256
TC_MIN_HEAD_DIM = 64


def served(head_dim):
    """Whether the attention kernels take ``head_dim`` (any from 1 up to
    256)."""
    return 1 <= head_dim <= MAX_HEAD_DIM


def padded_head_dim(head_dim):
    """The head dim the kernels run at: the next multiple of 16."""
    return -(-head_dim // HEAD_DIM_STEP) * HEAD_DIM_STEP


def pad_head_dim(t, width):
    """``t`` with its last axis zero-padded to ``width`` (a copy), or
    ``t`` itself when it is that wide already."""
    d = int(t.shape[-1])
    if d == width:
        return t
    return torch.nn.functional.pad(t, (0, width - d))


def padded_forward(fn, q, k, v, causal, scale):
    """``fn(q, k, v, causal, scale) -> (O, LSE)`` at the padded head dim:
    q, k, v zero-padded to it (when they are not that wide), O sliced
    back. ``scale`` is the true head dim's."""
    d = int(q.shape[-1])
    dp = padded_head_dim(d)
    if dp == d:
        return fn(q, k, v, causal, scale)
    o, lse = fn(*(pad_head_dim(t, dp) for t in (q, k, v)), causal, scale)
    return o[..., :d].contiguous(), lse


def padded_backward(fn, q, k, v, o, lse, do, causal, scale):
    """``fn(q, k, v, o, lse, do, causal, scale) -> (dq, dk, dv)`` at the
    padded head dim, the gradients sliced back (a zero column of q, k, v,
    o and dO gives zero gradient columns and adds nothing to Delta)."""
    d = int(q.shape[-1])
    dp = padded_head_dim(d)
    if dp == d:
        return fn(q, k, v, o, lse, do, causal, scale)
    grads = fn(*(pad_head_dim(t, dp) for t in (q, k, v, o)), lse,
               pad_head_dim(do, dp), causal, scale)
    return tuple(g[..., :d].contiguous() for g in grads)


def design(dtype, head_dim, backward=False):
    """``"tc"`` (tensor cores): the design the C entry points run for
    every dtype and head dim they take, forward or backward (the CUDA
    cores, ``"cc"``, run only on request)."""
    return "tc"


def split_width(head_dim):
    """The width at which the split design runs a head dim: 64, 128 above
    64, 256 above 128."""
    return 64 if head_dim <= 64 else 128 if head_dim <= 128 else 256


def split_workspace_elems(b, sq, sk, h, d, n_q, n_k):
    """bf16 values of the split design's three-part operands: ``3 x rows
    x heads x split_width`` (the C entry points' layout) for ``n_q``
    operands of ``b x sq`` rows and ``n_k`` of ``b x sk``."""
    return 3 * b * (n_q * sq + n_k * sk) * h * split_width(d)


def split_workspace(q, sk, n_q, n_k, cuda_cores):
    """The bf16 workspace of an fp32 call's three-part operands (None for
    bf16, or on the CUDA cores): :func:`split_workspace_elems` values."""
    b, sq, h, d = (int(x) for x in q.shape)
    if cuda_cores or q.dtype != torch.float32:
        return None
    return torch.empty(split_workspace_elems(b, sq, sk, h, d, n_q, n_k),
                       dtype=torch.bfloat16, device=q.device)


def check_head_dim(d, what="flash attention kernel"):
    """Raise for a head dim the attention kernels (flash, rope-on-load,
    paged) do not take, naming the queue that lists it."""
    if not served(d):
        raise ValueError(
            f"{what} takes a head_dim up to {MAX_HEAD_DIM}, got {d} (a "
            f"wider head needs kernels tiled over the head dim: ROADMAP.md "
            f"queue C item 1)")


def _scale_of(q, scale):
    if scale is None:
        return 1.0 / math.sqrt(int(q.shape[-1]))
    return float(scale)


def _check_shapes(q, k, v, causal):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention takes [B, S, H, D] q, k and v")
    b, sq, h, d = (int(s) for s in q.shape)
    if tuple(k.shape) != tuple(v.shape) or k.shape[0] != b \
            or k.shape[2] != h or k.shape[3] != d:
        raise ValueError(
            f"flash attention needs k and v of shape [{b}, Sk, {h}, {d}] "
            f"(repeat kv heads first), got {tuple(k.shape)} and "
            f"{tuple(v.shape)}"
        )
    sk = int(k.shape[1])
    if sk == 0:
        raise ValueError("flash attention needs at least one key")
    if causal and sk < sq:
        raise ValueError(
            f"causal flash attention is aligned bottom-right and needs "
            f"Sk >= Sq (a row must see a key), got Sq={sq}, Sk={sk}"
        )
    return b, sq, sk, h, d


def _scores(q, k, causal, scale):
    """fp32 scores ``[B, H, Sq, Sk]`` with the causal mask applied."""
    s = torch.matmul(q.float().transpose(1, 2),
                     k.float().permute(0, 2, 3, 1)) * scale
    if causal:
        sq, sk = int(s.shape[-2]), int(s.shape[-1])
        keep = torch.ones((sq, sk), dtype=torch.bool,
                          device=s.device).tril(sk - sq)
        s = s.masked_fill(~keep, float("-inf"))
    return s


def _rounded(x, dtype):
    """``x`` rounded to ``dtype`` and back to fp32 (the stock kernel's
    ``.astype`` before a product; a no-op for fp32)."""
    return x.to(dtype).float()


def flash_attention_reference(q, k, v, causal=False, scale=None):
    """Plain PyTorch version of the forward: ``(O, LSE)``. P is rounded
    to v's dtype before the value product (stock ``p.astype(v.dtype)``,
    here the normalised P)."""
    _check_shapes(q, k, v, causal)
    scale = _scale_of(q, scale)
    s = _scores(q, k, causal, scale)
    lse = torch.logsumexp(s, dim=-1)                        # [B, H, Sq]
    p = _rounded(torch.exp(s - lse[..., None]), v.dtype)
    o = torch.matmul(p, v.float().transpose(1, 2))          # [B, H, Sq, D]
    return o.transpose(1, 2).to(q.dtype), lse


def flash_attention_backward_reference(q, k, v, o, lse, do, causal=False,
                                       scale=None):
    """Plain PyTorch version of the backward: ``(dq, dk, dv)`` in the
    inputs' dtypes. ``Delta = rowsum(dO * O)`` with O as the forward
    stored it; ``P = exp(S - LSE)``; ``dS = P * (dO V^T - Delta) *
    scale``. P is rounded to the inputs' dtype before ``dV = P^T dO``
    (stock ``p.T.astype``), dS before ``dK = dS^T Q`` and ``dQ = dS K``
    (stock ``ds.T.astype``, ``ds.astype``; scaled first, as there)."""
    _check_shapes(q, k, v, causal)
    scale = _scale_of(q, scale)
    p, ds, g = _probabilities(q, k, v, o, lse, do, causal, scale)
    dv = torch.matmul(_rounded(p, q.dtype).transpose(-1, -2), g)
    ds = _rounded(ds * scale, q.dtype)
    dq = torch.matmul(ds, k.float().transpose(1, 2))        # [B, H, Sq, D]
    dk = torch.matmul(ds.transpose(-1, -2), q.float().transpose(1, 2))
    return (dq.transpose(1, 2).to(q.dtype), dk.transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))


def _probabilities(q, k, v, o, lse, do, causal, scale):
    """fp32 ``P = exp(S - LSE)`` and the unscaled ``dS = P * (dO V^T -
    Delta)`` ``[B, H, Sq, Sk]``, and dO as ``[B, H, Sq, D]``."""
    s = _scores(q, k, causal, scale)
    p = torch.exp(s - lse[..., None])                       # [B, H, Sq, Sk]
    g = do.float().transpose(1, 2)                          # [B, H, Sq, D]
    delta = (g * o.float().transpose(1, 2)).sum(dim=-1)     # [B, H, Sq]
    dp = torch.matmul(g, v.float().permute(0, 2, 3, 1))     # [B, H, Sq, Sk]
    return p, p * (dp - delta[..., None]), g


def probability_rounding_slack(q, k, v, lse, o=None, do=None, causal=False,
                               scale=None):
    """Per output entry, what rounding P and dS to the inputs' dtype at
    other points than the plain version can move it by: ``o_slack`` ``[B,
    Sq, H, D]``, and with ``o`` and ``do`` also ``(dq, dk, dv)`` slacks
    in the shapes of q, k, v; all fp32, zero for fp32 inputs.

    Derivation. bf16 keeps 8 significant bits: rounding x to nearest
    moves it by at most ``u |x|``, ``u = 2^-8``. Each side rounds every
    entry of P (or dS) once, from fp32 values that agree to a few fp32
    ulps (scores summed in another order, the hardware exp2 for exp), so
    the two rounded entries differ by at most ``2u |x| = 2^-7 |x|`` (both
    round the same way, or to neighbouring bf16 values). Through a
    product with fp32 sums that bounds an output entry's difference by
    ``2^-7`` times the product of the absolute values: O ``2^-7 (|P|
    |V|)``, dV ``2^-7 (|P^T| |dO|)``, dK ``2^-7 scale (|dS^T| |Q|)``, dQ
    ``2^-7 scale (|dS| |K|)`` (dS unscaled). The bf16 kernel's forward
    rounds the unnormalised P of each tile (``exp2(S - m_j)``, m_j the
    running max) and rescales in fp32 afterwards; a relative rounding
    error survives that rescaling unchanged, so the same bound holds. The
    fp32 rescaling and the cast of the result are covered by the
    cast-once tolerance beside this slack. fp16 keeps 11 significant
    bits (``2u = 2^-10``) but flushes values below 2^-24 (its smallest
    subnormal) where bf16 keeps them: an entry of P or (scaled) dS
    rounds by at most ``u |x|`` or half the subnormal spacing 2^-25,
    so the two sides differ by at most ``2^-10 |x| + 2^-24``."""
    _check_shapes(q, k, v, causal)
    scale = _scale_of(q, scale)
    rel, tiny = _ROUNDING.get(q.dtype, (0.0, 0.0))
    backward = o is not None and do is not None
    if backward:
        p, ds, g = _probabilities(q, k, v, o, lse, do, causal, scale)
    else:
        p = torch.exp(_scores(q, k, causal, scale) - lse[..., None])

    def moved(x, mul=1.0):
        # what two roundings of each entry of x apart can move it by
        # (tiny: twice the half spacing of fp16's subnormals, where a
        # small P or dS flushes; zero where x is masked on both sides)
        x = x.abs() * mul
        return rel * x + tiny * (x > 0) if tiny else rel * x

    o_slack = torch.matmul(moved(p), v.float().abs().transpose(1, 2))
    if not backward:
        return o_slack.transpose(1, 2)
    dv = torch.matmul(moved(p).transpose(-1, -2), g.abs())
    ds = moved(ds, scale)
    dq = torch.matmul(ds, k.float().abs().transpose(1, 2))
    dk = torch.matmul(ds.transpose(-1, -2), q.float().abs().transpose(1, 2))
    return o_slack.transpose(1, 2), tuple(
        t.transpose(1, 2) for t in (dq, dk, dv))


# (2u, twice the subnormal half spacing) of the inputs' dtype: what two
# roundings of one fp32 value to it can differ by (probability_rounding_
# slack)
_ROUNDING = {torch.bfloat16: (2.0 ** -7, 0.0),
             torch.float16: (2.0 ** -10, 2.0 ** -24)}


def _forward(q, k, v, causal, scale):
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, scale)
    return flash_attention_cuda(q, k, v, causal, scale)


def _backward(q, k, v, o, lse, do, causal, scale):
    if q.device.type == "cpu":
        return flash_attention_backward_reference(q, k, v, o, lse, do,
                                                  causal, scale)
    return flash_attention_backward_cuda(q, k, v, o, lse, do, causal,
                                         scale)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = _naninf.kernel_op("flash_attention", _forward, q, k, v,
                                   causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _naninf.kernel_op("flash_attention", _backward, q, k,
                                       v, o, lse, do, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal=False, scale=None, return_lse=False):
    """Attention over ``[B, S, H, D]`` q, k, v; differentiable in all
    three. Returns O, or ``(O, LSE)`` with ``return_lse``."""
    o, lse = _FlashAttention.apply(q, k, v, bool(causal),
                                   _scale_of(q, scale))
    return (o, lse) if return_lse else o


# ------------------------------------------------------------------ kernels
def _strides(t, name, vec):
    if t.stride(-1) != 1:
        raise ValueError(f"flash attention: {name}'s last axis must be "
                         f"contiguous, got strides {tuple(t.stride())}")
    st = [int(x) for x in t.stride()[:3]]
    if any(x % vec for x in st) or t.data_ptr() % 16:
        raise ValueError(
            f"flash attention reads {name} in 16-byte vectors: its "
            f"strides {tuple(st)} must be multiples of {vec} and its data "
            f"16-byte aligned"
        )
    return st


def _check_cuda(tensors, dtype):
    dev = tensors[0][1].device
    if dev.type != "cuda":
        raise ValueError(f"flash attention kernel needs CUDA tensors, got "
                         f"{dev}")
    for name, t in tensors:
        if t.device != dev:
            raise ValueError(f"flash attention: {name} on {t.device}, q on "
                             f"{dev}")
        if t.dtype != dtype:
            raise TypeError(f"flash attention kernel takes one dtype: "
                            f"{name} is {t.dtype}, q is {dtype}")
    if dtype not in _build.FLOAT_TYPES:
        raise TypeError(f"flash attention kernel takes float32/bfloat16/"
                        f"float16, got {dtype}")
    return dev


def _check_fp16(dtype, head_dim, backward, cuda_cores):
    """fp16 runs the bf16 tensor-core kernels' fp16 instantiations: the
    forward at every head dim, the backward up to 128 (above, bf16 runs
    the one-part split kernels, which read bf16 only)."""
    if dtype != torch.float16:
        return
    if cuda_cores:
        raise _build.fp16_refused("the CUDA-core flash attention kernels",
                                  3)
    if backward and padded_head_dim(head_dim) > 128:
        raise _build.fp16_refused(
            f"the flash attention backward above head_dim 128 (got "
            f"{head_dim})", 3)


def _count(dtype, head_dim, backward, cuda_cores=False):
    """Add one launch to the total and to the counter of the design that
    ran (:func:`design`, the C entry points' dispatch, or the CUDA cores
    on request)."""
    total = "bwd_launches" if backward else "launches"
    counters = globals()
    counters[total] += 1
    if dtype == torch.float16:
        counters[f"fp16_{total}"] += 1
    kind = "cc" if cuda_cores else design(dtype, head_dim, backward)
    counters[f"{kind}_{total}"] += 1


def flash_attention_cuda(q, k, v, causal=False, scale=None,
                         cuda_cores=False):
    """Launch the forward of ``csrc/flash_attention.cu``: ``(O, LSE)``;
    :func:`design` says which kernels run (``cuda_cores``: the CUDA-core
    ones, to compare with)."""
    _, _, _, _, d = _check_shapes(q, k, v, causal)
    _check_cuda((("q", q), ("k", k), ("v", v)), q.dtype)
    check_head_dim(d)
    _check_fp16(q.dtype, d, False, cuda_cores)
    out = padded_forward(functools.partial(_launch_fwd, cuda_cores=cuda_cores),
                         q, k, v, causal, _scale_of(q, scale))
    _count(q.dtype, d, False, cuda_cores)
    return out


def _launch_fwd(q, k, v, causal, scale, cuda_cores=False):
    """The forward launch at a head dim that is a multiple of 16."""
    b, sq, sk, h, d = _check_shapes(q, k, v, causal)
    dev = q.device
    vec = 16 // q.element_size()
    st = [_strides(t, n, vec) for n, t in (("q", q), ("k", k), ("v", v))]
    lib = _build.load()
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=dev)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
    work = split_workspace(q, sk, 1, 2, cuda_cores)  # q; k, v
    with torch.cuda.device(dev):
        err = lib.ptt_flash_attention_fwd(
            _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(o),
            _build.ptr(lse), b, h, sq, sk, d, *st[0], *st[1], *st[2],
            int(bool(causal)), scale, _build.DTYPE_CODES[q.dtype],
            None if work is None else _build.ptr(work), int(cuda_cores),
            _build.stream_of(q),
        )
    _build.check(err, "ptt_flash_attention_fwd")
    return o, lse


def flash_attention_backward_cuda(q, k, v, o, lse, do, causal=False,
                                  scale=None, cuda_cores=False):
    """Launch the backward of ``csrc/flash_attention.cu`` (Delta, dK/dV
    and dQ passes): ``(dq, dk, dv)``; :func:`design` says which kernels
    run (``cuda_cores``: the CUDA-core ones, to compare with)."""
    b, sq, sk, h, d = _check_shapes(q, k, v, causal)
    do = do.to(q.dtype)
    vec = 16 // q.element_size()
    if do.stride(-1) != 1 or any(int(x) % vec for x in do.stride()[:3]):
        # e.g. the expanded gradient of a sum: the kernel reads vectors
        do = do.contiguous()
    dev = _check_cuda((("q", q), ("k", k), ("v", v), ("o", o),
                       ("dout", do)), q.dtype)
    check_head_dim(d)
    _check_fp16(q.dtype, d, True, cuda_cores)
    if tuple(o.shape) != tuple(q.shape) or tuple(do.shape) != tuple(q.shape):
        raise ValueError("flash attention backward: o and dout must have "
                         "q's shape")
    if lse.dtype != torch.float32 or tuple(lse.shape) != (b, h, sq) \
            or not lse.is_contiguous() or lse.device != dev:
        raise ValueError(f"flash attention backward: lse must be the "
                         f"forward's contiguous fp32 [{b}, {h}, {sq}]")
    grads = padded_backward(
        functools.partial(_launch_bwd, cuda_cores=cuda_cores), q, k, v, o,
        lse, do, causal, _scale_of(q, scale))
    _count(q.dtype, d, True, cuda_cores)
    return grads


def _launch_bwd(q, k, v, o, lse, do, causal, scale, cuda_cores=False):
    """The backward launch at a head dim that is a multiple of 16."""
    b, sq, sk, h, d = _check_shapes(q, k, v, causal)
    dev = q.device
    vec = 16 // q.element_size()
    st = [_strides(t, n, vec) for n, t in
          (("q", q), ("k", k), ("v", v), ("o", o), ("dout", do))]
    lib = _build.load()
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=dev)
    dk = torch.empty((b, sk, h, d), dtype=q.dtype, device=dev)
    dv = torch.empty((b, sk, h, d), dtype=q.dtype, device=dev)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
    work = split_workspace(q, sk, 2, 2, cuda_cores)  # q, dout; k, v
    with torch.cuda.device(dev):
        err = lib.ptt_flash_attention_bwd(
            _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(o),
            _build.ptr(do), _build.ptr(lse), _build.ptr(delta),
            _build.ptr(dq), _build.ptr(dk), _build.ptr(dv), b, h, sq, sk, d,
            *st[0], *st[1], *st[2], *st[3], *st[4], int(bool(causal)),
            scale, _build.DTYPE_CODES[q.dtype],
            None if work is None else _build.ptr(work), int(cuda_cores),
            _build.stream_of(q),
        )
    _build.check(err, "ptt_flash_attention_bwd")
    return dq, dk, dv
