"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked ``cuda`` and skips without a CUDA card.

This file imports neither jax nor paddle_tpu, so it also runs on a
machine that has only PyTorch; there, skip the repository's
jax-importing conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances as in chip_smoke.py: bf16 RMSNorm and rope within one bf16
ulp of the largest output (2^-7 relative), fp32 within 1e-5 relative;
paged attention 1e-2 (bf16) and 1e-5 (fp32) absolute. Backward kernels
and flash attention (both sides compute in fp32 and cast once; the sums
run in other orders): fp32 within 1e-4 of the largest entry for sums
over rows (RMSNorm dw, flash dK/dV/dQ, which cancel) and 1e-5
elsewhere; bf16 entry by entry, within 2^-7 of the entry (one to two
of its ulps: the cast may round the two sides one ulp apart) plus that
fp32 tolerance, by which the values before the cast may differ. The
int8 paged attention kernel: as the float one (both sides dequantize in
fp32 the same way). The W8A16 matmul: cast once, fp32 1e-5 of the
largest entry (fp32 sums over K in another order), bf16 entry by entry
as above. The fused RMSNorm + matmul and the fused rope + attention:
cast once, fp32 1e-5 of the largest entry at the small shapes and 1e-4
for the fp32 products over K = 4096 and attention over 2048 keys (sums
in another order over thousands of terms), bf16 entry by entry as above;
the fused RMSNorm + matmul adds, per entry, what the rounding of the
normed row may move it by when the kernel's rstd rounds an entry near a
midpoint the other way (``normed_rounding_slack``); the bf16 rope-on-load
tensor-core kernel adds what its split products may move an entry by
(``split_product_slack``). bf16 flash attention
adds, per entry, what rounding P and dS at other points than the plain
version may move it by (``probability_rounding_slack``: the tensor-core
kernels round the unnormalised P of each tile). The serving engines'
decode program, a CUDA graph, is held bit-equal to the eager step it
replays (the same kernels on the same inputs), with its launch counts;
a prefix engine's warm admissions (gather, chunk prefill and adopt
graphs) bit-equal to its eager run, and one chunk capture replayed at
two starts bit-equal to the eager chunk there and within 1e-5 of the
largest logit of the full prefill. The slab engine's speculative verify
program (bf16, parallel; int8, sequential), captured once by
``warmup()``, replayed at two positions over the same block: logits and
the written block bit-equal to the eager verify body at each. The paged
engine's verify (decode replays over the arena) scores every position
with the vanilla paged decode step's row bit for bit (bf16 and int8,
also with more positions than rows). A page spilled to the host tier and
restored lands bit-equal.
``generate``'s program (one CUDA graph a signature) equals its eager loop
token for token (greedy, sampled, beam), an in-place weight update
showing in the next replay; an async checkpoint save fenced by the
trainer equals a host copy taken at the save although the next updates
ran in place; a live reload keeps the parameters' addresses and the
captures and serves the new net's streams.
The multi-tensor optimizer kernels: Adam/AdamW and SGD/Momentum bit for
bit given the same stats (every operation rounded once on both sides),
the sums of squares within 1e-6 relative (fp32 sums in another order) and
bit-equal on a repeat, Lamb's moments bit for bit and its parameters
within 1e-6 of the tensor's largest |p| (its norms are sums in another
order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu_torch.kernels import flash_attention as tfa  # noqa: E402
from paddle_tpu_torch.kernels import fused_adam as tfad  # noqa: E402
from paddle_tpu_torch.kernels import fused_norm_matmul as tfnm  # noqa: E402
from paddle_tpu_torch.kernels import fused_rope_attention as tfra  # noqa
from paddle_tpu_torch.kernels import int8_matmul as tim  # noqa: E402
from paddle_tpu_torch.kernels import paged_attention as tpa  # noqa: E402
from paddle_tpu_torch.kernels import rms_norm as trms  # noqa: E402
from paddle_tpu_torch.kernels import rope as trope  # noqa: E402

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
REL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
PAGED = {"float32": 1e-5, "bfloat16": 1e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels run only there)")
    return torch.device("cuda", 0)


def _err(a, b):
    return float((a.float() - b.float()).abs().max())


def _rel_ok(got, want, tol):
    return _err(got, want) <= tol * float(want.float().abs().max())


def _cast_once_ok(got, want, tol32, slack=None):
    """fp32: within ``tol32`` of the largest entry; bf16: each entry
    within 2^-7 of it plus that fp32 tolerance, plus its ``slack`` (what
    rounding an operand at another point may move it by)."""
    if got.dtype == torch.float32:
        return _rel_ok(got, want, tol32)
    ref = want.float().abs()
    tol = 2.0 ** -7 * ref + tol32 * float(ref.max())
    if slack is not None:
        tol = tol + slack
    return bool(((got.float() - want.float()).abs() <= tol).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rms_norm_kernel(dev, dtype):
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(5, 3, 256, generator=g, device=dev).to(DTYPES[dtype])
    w = torch.randn(256, generator=g, device=dev).to(DTYPES[dtype])
    y = trms.rms_norm(x, w, 1e-5)
    ref = trms.rms_norm_reference(x, w, 1e-5)
    assert y.dtype == x.dtype and y.shape == x.shape
    assert _err(y, ref) <= REL[dtype] * float(ref.float().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rope_kernel_shared_and_position_ids(dev, dtype):
    g = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn(2, 3, 4, 32, generator=g, device=dev).to(DTYPES[dtype])
    k = torch.randn(2, 3, 2, 32, generator=g, device=dev).to(DTYPES[dtype])
    cos, sin = trope.build_rope_cache(3, 32, device=dev)
    qo, ko = trope.rope_fused(q, k, cos, sin)
    assert torch.equal(qo, trope.rope_reference(q, cos, sin))
    assert torch.equal(ko, trope.rope_reference(k, cos, sin))
    cos, sin = trope.build_rope_cache(64, 32, device=dev)
    ids = torch.tensor([[0, 5, 63], [7, 8, 9]], dtype=torch.int32,
                       device=dev)
    qo, _ = trope.rope_fused(q, None, cos, sin, ids)
    assert torch.equal(qo, trope.rope_reference(q, cos, sin, ids))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("d", [72, 40])
def test_rope_kernel_pads_unaligned_halves(dev, dtype, d):
    """Head dims whose half is not a whole number of the kernel's 16-byte
    vectors (bf16 72 and 40): the wrapper pads each half, and the
    rotation, forward and backward, with position ids, equals the plain
    version's."""
    dt = DTYPES[dtype]
    g = torch.Generator(device=dev).manual_seed(d)
    q = torch.randn(2, 5, 4, d, generator=g, device=dev).to(dt)
    k = torch.randn(2, 5, 2, d, generator=g, device=dev).to(dt)
    cos, sin = trope.build_rope_cache(16, d, device=dev)
    ids = torch.randint(0, 16, (2, 5), generator=g, device=dev)
    qo, ko = trope.rope_cuda(q, k, cos, sin, ids)
    assert qo.shape == q.shape and ko.shape == k.shape
    assert _rel_ok(qo, trope.rope_reference(q, cos, sin, ids), REL[dtype])
    assert _rel_ok(ko, trope.rope_reference(k, cos, sin, ids), REL[dtype])
    gq, _ = trope.rope_cuda(q, None, cos, sin, ids, inverse=True)
    assert _rel_ok(gq, trope.rope_backward_reference(q, cos, sin, ids),
                   REL[dtype])


def _arena(dev, dtype, kvh, d, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    b, h, ps, width = 3, 8, 8, 5
    n = b * width + 1
    kp = torch.randn(n, ps, kvh, d, generator=g, device=dev).to(dtype)
    vp = torch.randn(n, ps, kvh, d, generator=g, device=dev).to(dtype)
    kp[0] = 1e4  # the garbage page: never inside a live range
    vp[0] = 1e4
    tbl = (1 + torch.arange(b * width, device=dev)).reshape(b, width)
    pos = torch.tensor([0, 17, 39], dtype=torch.int32, device=dev)
    live = (pos.long() // ps + 1)[:, None]
    tbl = torch.where(torch.arange(width, device=dev)[None] < live, tbl, 0)
    q = torch.randn(b, 1, h, d, generator=g, device=dev).to(dtype)
    return q, kp, vp, tbl.to(torch.int32).contiguous(), pos


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kvh", [8, 2, 1])
@pytest.mark.parametrize("d", [16, 32, 64, 128, 256, 80, 96, 72, 40, 50])
def test_paged_attention_kernel(dev, dtype, kvh, d):
    args = _arena(dev, DTYPES[dtype], kvh, d, seed=kvh * 1000 + d)
    got = tpa.paged_attention(*args)
    want = tpa.paged_attention_reference(*args)
    assert got.dtype == args[0].dtype and torch.isfinite(got).all()
    assert _err(got, want) <= PAGED[dtype]
    # the chunks' partials are summed in chunk order: bit-equal repeats
    assert torch.equal(tpa.paged_attention(*args), got)


def _long_arena(dev, dtype, h, kvh, d, slots, seed, ps=16):
    """One row of ``slots`` live slots (pos = slots - 1) and one short
    row, pages shuffled over the arena, the garbage page at 1e4."""
    g = torch.Generator(device=dev).manual_seed(seed)
    width = slots // ps
    n = 2 * width + 1
    kp = torch.randn(n, ps, kvh, d, generator=g, device=dev).to(dtype)
    vp = torch.randn(n, ps, kvh, d, generator=g, device=dev).to(dtype)
    kp[0] = 1e4
    vp[0] = 1e4
    tbl = (torch.randperm(n - 1, generator=g, device=dev) + 1)
    tbl = tbl.reshape(2, width).to(torch.int32)
    pos = torch.tensor([slots - 1, 40], dtype=torch.int32, device=dev)
    tbl[1, 40 // ps + 1:] = 0
    q = torch.randn(2, 1, h, d, generator=g, device=dev).to(dtype)
    return q, kp, vp, tbl.contiguous(), pos


# query heads, kv heads, head_dim, live slots of the long row: MQA with 16
# and 32 query heads per kv head, Llama-2-70B's group of 8 and Llama-3-8B's
# group of 4 at 8192 slots (past the earlier design's shared-memory cap
# of about 7,000 slots at group 8), head dim 80 at 4096 slots
PAGED_LONG_CASES = {
    "mqa_g16": (16, 1, 128, 2048),
    "mqa_g32": (32, 1, 128, 2048),
    "g8_8192": (64, 8, 128, 8192),
    "g4_8192": (32, 8, 128, 8192),
    "d80_g4_4096": (16, 4, 80, 4096),
}


@pytest.mark.cuda
@pytest.mark.parametrize("arena", ["bfloat16", "float32", "int8"])
@pytest.mark.parametrize("case", list(PAGED_LONG_CASES))
def test_paged_attention_groups_and_long_rows(dev, arena, case):
    """Any group size and any row length: within the paged tolerance of
    the plain version, one count a call, bit-equal on repeat."""
    from paddle_tpu_torch.quantization.kv import QuantizedKV, quantize_kv

    h, kvh, d, slots = PAGED_LONG_CASES[case]
    dt = torch.float32 if arena == "int8" else DTYPES[arena]
    q, kp, vp, tbl, pos = _long_arena(dev, dt, h, kvh, d, slots,
                                      seed=h + kvh + d + slots)
    if arena == "int8":
        kp, vp = QuantizedKV(*quantize_kv(kp)), QuantizedKV(*quantize_kv(vp))
        q = q.bfloat16()
    before = (tpa.launches, tpa.int8_launches)
    got = tpa.paged_attention(q, kp, vp, tbl, pos)
    after = (tpa.launches, tpa.int8_launches)
    assert after == ((before[0], before[1] + 1) if arena == "int8"
                     else (before[0] + 1, before[1]))
    want = tpa.paged_attention_reference(q, kp, vp, tbl, pos)
    assert got.dtype == q.dtype and torch.isfinite(got).all()
    tol = PAGED["float32" if q.dtype == torch.float32 else "bfloat16"]
    assert _err(got, want) <= tol
    assert torch.equal(tpa.paged_attention(q, kp, vp, tbl, pos), got)


@pytest.mark.cuda
def test_paged_attention_refuses_head_dims(dev):
    """A head dim above 256 is refused naming the queue item that lists
    it; one that is not a multiple of 16 (72) runs on an unpadded arena
    and matches its plain version."""
    q, kp, vp, tbl, pos = _arena(dev, torch.bfloat16, 2, 272, seed=272)
    with pytest.raises(ValueError,
                       match="head_dim.*ROADMAP.md queue C item 1"):
        tpa.paged_attention(q, kp, vp, tbl, pos)
    args = _arena(dev, torch.bfloat16, 2, 72, seed=72)
    got = tpa.paged_attention(*args)
    assert got.shape == args[0].shape
    assert _err(got, tpa.paged_attention_reference(*args)) <= PAGED[
        "bfloat16"]


@pytest.mark.cuda
def test_paged_attention_kernel_mixed_dtypes(dev):
    """An fp32 model over the default bf16 arena runs; a bf16 q over an
    fp32 arena is refused, not computed some other way."""
    q, kp, vp, tbl, pos = _arena(dev, torch.bfloat16, 2, 64, seed=3)
    args = (q.float(), kp, vp, tbl, pos)
    assert _err(tpa.paged_attention(*args),
                tpa.paged_attention_reference(*args)) <= 1e-5
    with pytest.raises(TypeError, match="arenas"):
        tpa.paged_attention(q, kp.float(), vp.float(), tbl, pos)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kvh", [8, 2])
@pytest.mark.parametrize("d", [16, 32, 64, 128, 256, 80, 96, 72, 40, 51])
def test_int8_paged_attention_kernel(dev, dtype, kvh, d):
    from paddle_tpu_torch.quantization.kv import QuantizedKV, quantize_kv

    q, kp, vp, tbl, pos = _arena(dev, torch.float32, kvh, d,
                                 seed=kvh * 100 + d)
    kq, vq = QuantizedKV(*quantize_kv(kp)), QuantizedKV(*quantize_kv(vp))
    q = q.to(DTYPES[dtype])
    before = tpa.int8_launches
    got = tpa.paged_attention(q, kq, vq, tbl, pos)
    assert tpa.int8_launches == before + 1
    want = tpa.paged_attention_reference(q, kq, vq, tbl, pos)
    assert got.dtype == q.dtype and torch.isfinite(got).all()
    assert _err(got, want) <= PAGED[dtype]
    assert torch.equal(tpa.paged_attention(q, kq, vq, tbl, pos), got)


@pytest.mark.cuda
def test_int8_paged_attention_refuses(dev):
    from paddle_tpu_torch.quantization.kv import QuantizedKV, quantize_kv

    q, kp, vp, tbl, pos = _arena(dev, torch.float32, 2, 64, seed=7)
    kq, vq = QuantizedKV(*quantize_kv(kp)), QuantizedKV(*quantize_kv(vp))
    # an fp16 q names its ROADMAP line (no fp16 paged kernel yet)
    with pytest.raises(TypeError, match="queue B, fp16 item 4"):
        tpa.paged_attention(q.half(), kq, vq, tbl, pos)
    with pytest.raises(TypeError, match="float32 or bfloat16 q"):
        tpa.paged_attention(q.double(), kq, vq, tbl, pos)
    bad = QuantizedKV(kq.q, kq.scale[..., :1].contiguous())
    with pytest.raises(ValueError, match="scales"):
        tpa.paged_attention(q, bad, vq, tbl, pos)
    with pytest.raises(ValueError, match="share quantization"):
        tpa.paged_attention(q, kq, vp, tbl, pos)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("rows", [1, 3, 8, 17, 130])
def test_int8_matmul_kernel(dev, dtype, rows):
    """K 1040 (three K chunks of the narrow kernel, the last ragged; not
    a multiple of the tensor-core k-tile), N 200 (not a multiple of the
    128-column tile, nor of 16)."""
    g = torch.Generator(device=dev).manual_seed(rows)
    k, n = 1040, 200
    x = torch.randn(rows, k, generator=g, device=dev).to(DTYPES[dtype])
    wq, sc = tim.quantize_weight(torch.randn(k, n, generator=g, device=dev))
    before = tim.launches
    counter = f"{tim.design(x.dtype)}_launches"
    before_design = getattr(tim, counter)
    y = tim.int8_matmul(x, wq, sc)
    assert tim.launches == before + 1
    assert getattr(tim, counter) == before_design + 1
    ref = tim.int8_matmul_reference(x, wq, sc)
    assert y.dtype == x.dtype and y.shape == (rows, n)
    assert torch.isfinite(y).all()
    assert _cast_once_ok(y, ref, 1e-5)
    # no atomics: a second run is bit-equal
    assert torch.equal(y, tim.int8_matmul(x, wq, sc))


@pytest.mark.cuda
def test_int8_matmul_leading_dims_and_refusals(dev):
    g = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn(2, 5, 64, generator=g, device=dev)
    wq, sc = tim.quantize_weight(torch.randn(64, 48, generator=g, device=dev))
    y = tim.int8_matmul(x, wq, sc)
    assert y.shape == (2, 5, 48)
    assert _cast_once_ok(y, tim.int8_matmul_reference(x, wq, sc), 1e-5)
    with pytest.raises(TypeError, match="queue B, fp16 item 4"):
        tim.int8_matmul(x.half(), wq, sc)
    with pytest.raises(TypeError, match="float32 or bfloat16 x"):
        tim.int8_matmul(x.double(), wq, sc)
    with pytest.raises(TypeError, match="int8 weight"):
        tim.int8_matmul(x, wq.float(), sc)
    with pytest.raises(ValueError, match="multiples of 8"):
        tim.int8_matmul(x[..., :60], wq[:60], sc)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 8, 16, 17, 64, 130, 1024])
@pytest.mark.parametrize("k", [1040, 4096])
@pytest.mark.parametrize("n", [264, 22016])
def test_int8_matmul_tensor_cores(dev, rows, k, n):
    """The bf16 design: the swap-AB kernel up to SWAP_MAX_ROWS rows, the
    tiled one above; K 1040 is not a multiple of the 64-row k-tile (its
    ragged tile is zero-filled), N 264 is not a multiple of 16 nor of the
    128-column tile. Cast once (bf16 entry by entry), bit-equal on
    repeat, and counted on the tensor-core design."""
    from paddle_tpu_torch import kernels

    g = torch.Generator(device=dev).manual_seed(rows * 7 + k + n)
    x = torch.randn(rows, k, generator=g, device=dev).to(torch.bfloat16)
    wq, sc = tim.quantize_weight(
        0.02 * torch.randn(k, n, generator=g, device=dev))
    kernels.reset_launch_counts()
    y = tim.int8_matmul(x, wq, sc)
    assert kernels.int8_matmul_design_counts() == {"tc_launches": 1,
                                                   "cc_launches": 0}
    ref = tim.int8_matmul_reference(x, wq, sc)
    assert y.dtype == x.dtype and y.shape == (rows, n)
    assert torch.isfinite(y).all()
    assert _cast_once_ok(y, ref, 1e-5)
    assert torch.equal(y, tim.int8_matmul(x, wq, sc))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["swap", "tiled"])
@pytest.mark.parametrize("rows", [8, 64])
def test_int8_matmul_each_kernel(dev, kernel, rows):
    """Each tensor-core kernel named explicitly (as chip_smoke.py's
    crossover sweep runs them side by side) at the 7B decode widths,
    within cast-once of the plain version, bit-equal on repeat and
    counted on the tensor-core design."""
    g = torch.Generator(device=dev).manual_seed(rows)
    x = torch.randn(rows, 4096, generator=g, device=dev).to(torch.bfloat16)
    wq, sc = tim.quantize_weight(
        0.02 * torch.randn(4096, 4096, generator=g, device=dev))
    before = (tim.tc_launches, tim.cc_launches)
    y = tim._tc_kernel(x, wq, sc, kernel)
    assert (tim.tc_launches, tim.cc_launches) == (before[0] + 1, before[1])
    assert _cast_once_ok(y, tim.int8_matmul_reference(x, wq, sc), 1e-5)
    assert torch.equal(y, tim._tc_kernel(x, wq, sc, kernel))
    with pytest.raises(ValueError, match="no 'swap' kernel"):
        tim._tc_kernel(x.float(), wq, sc, "swap")


@pytest.mark.cuda
def test_kernels_count_launches(dev):
    from paddle_tpu_torch import kernels

    kernels.reset_launch_counts()
    x = torch.randn(2, 64, device=dev, requires_grad=True)
    y = trms.rms_norm(x, torch.ones(64, device=dev))
    trms.rms_norm_reference(x, torch.ones(64, device=dev))
    y.sum().backward()
    want = dict.fromkeys(kernels.KERNELS, 0)
    want.update(rms_norm=1, rms_norm_bwd=1)
    assert kernels.launch_counts() == want


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rms_norm_backward_kernel(dev, dtype):
    g = torch.Generator(device=dev).manual_seed(5)
    dt = DTYPES[dtype]
    x = torch.randn(300, 512, generator=g, device=dev).to(dt)
    w = (1 + 0.1 * torch.randn(512, generator=g, device=dev)).to(dt)
    gy = torch.randn(300, 512, generator=g, device=dev).to(dt)
    _, rstd = trms.rms_norm_cuda(x, w, 1e-5, return_rstd=True)
    _, rstd_ref = trms.rms_norm_reference(x, w, 1e-5, return_rstd=True)
    assert _rel_ok(rstd, rstd_ref, 1e-6)
    dx, dw = trms.rms_norm_backward_cuda(x, w, gy, rstd)
    rdx, rdw = trms.rms_norm_backward_reference(x, w, gy, rstd)
    assert dx.dtype == dt and dw.dtype == dt
    assert _cast_once_ok(dx, rdx, 1e-5)
    assert _cast_once_ok(dw, rdw, 1e-4)
    # no float atomics: a second run is bit-equal
    dx2, dw2 = trms.rms_norm_backward_cuda(x, w, gy, rstd)
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rope_backward_kernel(dev, dtype):
    g = torch.Generator(device=dev).manual_seed(6)
    dt = DTYPES[dtype]
    q = torch.randn(2, 5, 4, 64, generator=g, device=dev).to(dt)
    k = torch.randn(2, 5, 2, 64, generator=g, device=dev).to(dt)
    cos, sin = trope.build_rope_cache(5, 64, device=dev)
    dq, dk = trope.rope_cuda(q, k, cos, sin, inverse=True)
    assert torch.equal(dq, trope.rope_backward_reference(q, cos, sin))
    assert torch.equal(dk, trope.rope_backward_reference(k, cos, sin))
    # through autograd: the forward then the inverse rotation
    qg = q.clone().requires_grad_(True)
    qo, _ = trope.rope_fused(qg, None, cos, sin)
    qo.backward(q)
    assert torch.equal(qg.grad, dq)


def _flash_inputs(dev, dtype, b, sq, sk, h, d, seed, strided=False):
    g = torch.Generator(device=dev).manual_seed(seed)
    if strided:
        # q, k, v as views of one fused [B, S, 3, H, D] projection
        qkv = torch.randn(b, sq, 3, h, d, generator=g, device=dev).to(dtype)
        q, k, v = qkv.unbind(2)
    else:
        q = torch.randn(b, sq, h, d, generator=g, device=dev).to(dtype)
        k = torch.randn(b, sk, h, d, generator=g, device=dev).to(dtype)
        v = torch.randn(b, sk, h, d, generator=g, device=dev).to(dtype)
    do = torch.randn(b, sq, h, d, generator=g, device=dev).to(dtype)
    return q, k, v, do


FLASH_CASES = {
    # causal, sq, sk, head_dim, strided q/k/v views
    "causal": (True, 130, 130, 128, False),
    "causal_d16": (True, 130, 130, 16, False),
    "full_d32": (False, 100, 77, 32, False),
    "causal_d256": (True, 130, 130, 256, False),
    "causal_d256_sq_lt_sk": (True, 70, 200, 256, False),
    "causal_sq_lt_sk": (True, 70, 200, 64, False),
    "full": (False, 100, 77, 128, False),
    "causal_strided": (True, 96, 96, 64, True),
    "causal_ragged_1000": (True, 1000, 1000, 128, False),
    "full_sk_gt_sq": (False, 300, 1000, 128, False),
    "causal_d64_sq_lt_sk": (True, 200, 333, 64, False),
    # head dims on the padded kernels: 80, 96 (128 wide; the tensor cores
    # both ways, fp32 through split products), 160 and 192 (256 wide; bf16
    # on the tensor cores both ways, fp32 through split products on pairs
    # of CTAs), 48 (64 wide, the tensor cores)
    "causal_d80": (True, 130, 130, 80, False),
    "full_d96": (False, 100, 77, 96, False),
    "causal_d96_sq_lt_sk": (True, 70, 200, 96, False),
    "causal_d80_strided": (True, 96, 96, 80, True),
    "causal_d160": (True, 130, 130, 160, False),
    "causal_d192": (True, 130, 130, 192, False),
    "full_d48": (False, 100, 77, 48, False),
    # head dims that are not multiples of 16: zero-padded by the wrapper
    # (72 to 80, 40 to 48: the tensor cores both ways)
    "causal_d72": (True, 130, 130, 72, False),
    "full_d40": (False, 100, 77, 40, False),
    "causal_d72_strided": (True, 96, 96, 72, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention_kernels(dev, dtype, case):
    causal, sq, sk, d, strided = FLASH_CASES[case]
    dt = DTYPES[dtype]
    q, k, v, do = _flash_inputs(dev, dt, 2, sq, sk, 3, d, seed=sq + sk,
                                strided=strided)
    o, lse = tfa.flash_attention_cuda(q, k, v, causal)
    ro, rlse = tfa.flash_attention_reference(q, k, v, causal)
    # bf16: the kernels round P and dS where the plain version does not
    # (unnormalised P tile by tile); each entry gets that slack
    o_slack, slacks = tfa.probability_rounding_slack(q, k, v, lse, o, do,
                                                     causal)
    assert o.dtype == dt and torch.isfinite(o).all()
    assert _cast_once_ok(o, ro, 1e-5, o_slack)
    assert _err(lse, rlse) <= 1e-5 * float(rlse.abs().max())
    grads = tfa.flash_attention_backward_cuda(q, k, v, o, lse, do, causal)
    want = tfa.flash_attention_backward_reference(q, k, v, o, lse, do,
                                                  causal)
    for got, ref, slack in zip(grads, want, slacks):
        assert got.dtype == dt and torch.isfinite(got).all()
        assert _cast_once_ok(got, ref, 1e-4, slack)
    # no float atomics: the gradients repeat bit for bit
    again = tfa.flash_attention_backward_cuda(q, k, v, o, lse, do, causal)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32, 64, 128, 256, 80, 96, 160, 192, 72,
                               40])
def test_flash_attention_dispatches_by_dtype(dev, d):
    """The tensor-core kernels run every head dim in both dtypes, both
    ways (bf16 below 64 at the 64-wide kernels, above 128 the backward on
    the split design's one-part kernels; fp32 through split products,
    above 128 on pairs of CTAs). ``cuda_cores=True`` runs the CUDA-core
    kernels at any head dim and counts them there."""
    from paddle_tpu_torch import kernels

    for dt in (torch.bfloat16, torch.float32):
        q, k, v, do = _flash_inputs(dev, dt, 1, 64, 64, 2, d, seed=3)
        kernels.reset_launch_counts()
        o, lse = tfa.flash_attention_cuda(q, k, v, True)
        tfa.flash_attention_backward_cuda(q, k, v, o, lse, do, True)
        kind = "tc"
        want = dict.fromkeys(tfa.DESIGN_COUNTERS, 0)
        want[f"{kind}_launches"] += 1
        want[f"{kind}_bwd_launches"] += 1
        assert kernels.flash_design_counts() == want
        assert (tfa.design(dt, d), tfa.design(dt, d, True)) == (kind, kind)
        assert tfa.launches == 1 and tfa.bwd_launches == 1
        kernels.reset_launch_counts()
        o2, lse2 = tfa.flash_attention_cuda(q, k, v, True, cuda_cores=True)
        tfa.flash_attention_backward_cuda(q, k, v, o2, lse2, do, True,
                                          cuda_cores=True)
        assert kernels.flash_design_counts() == {
            "tc_launches": 0, "tc_bwd_launches": 0, "cc_launches": 1,
            "cc_bwd_launches": 1}


@pytest.mark.cuda
def test_flash_attention_refuses_what_it_does_not_take(dev):
    """Head dims 80 and 72 (once refused: 72 is not a multiple of 16, so
    the wrapper pads it) run and match their plain versions; a head dim
    above 256 (272) is refused, naming the queue item that lists it, in
    both directions."""
    for d in (80, 72):
        q = torch.randn(1, 8, 2, d, device=dev)
        o, lse = tfa.flash_attention_cuda(q, q, q)
        ro, rlse = tfa.flash_attention_reference(q, q, q)
        assert o.shape == q.shape and _cast_once_ok(o, ro, 1e-5)
        assert _err(lse, rlse) <= 1e-5 * float(rlse.abs().max())
    q = torch.randn(1, 8, 2, 272, device=dev)
    with pytest.raises(ValueError,
                       match="head_dim.*ROADMAP.md queue C item 1"):
        tfa.flash_attention_cuda(q, q, q)
    lse = torch.zeros(1, 2, 8, device=dev)
    with pytest.raises(ValueError,
                       match="head_dim.*ROADMAP.md queue C item 1"):
        tfa.flash_attention_backward_cuda(q, q, q, q, lse, q)
    q = torch.randn(1, 8, 2, 64, device=dev)
    with pytest.raises(TypeError, match="one dtype"):
        tfa.flash_attention_cuda(q, q.bfloat16(), q)


@pytest.mark.cuda
def test_tiny_paged_engine_matches_generate(dev):
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import PagedServingEngine

    cfg = LlamaConfig.tiny(vocab_size=256, hidden_size=256,
                           intermediate_size=512, num_attention_heads=4,
                           num_key_value_heads=2)
    net = LlamaForCausalLM(cfg, device=dev, seed=4)
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, 256, (n,)) for n in (9, 17, 30, 5)]
    eng = PagedServingEngine(net, max_batch_size=2, max_seq_len=64,
                             page_size=8, min_bucket=8,
                             cache_dtype="float32")
    handles = [eng.submit(p, 10) for p in prompts]
    eng.run_until_idle()
    for h, p in zip(handles, prompts):
        want = net.generate(p[None], max_new_tokens=10,
                            cache_dtype="float32")[0].cpu().numpy()
        np.testing.assert_array_equal(h.output_ids, want)
    assert eng.page_pool.pages_in_use == 0


@pytest.mark.cuda
def test_tiny_int8_engines_match_generate(dev):
    """A quantized tiny model (W8A16 kernel) with int8 caches: the paged
    engine (int8 paged kernel) and the slab engine stream what
    ``generate(cache_dtype="int8")`` gives."""
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.quantization import quantize_for_serving
    from paddle_tpu_torch.serving import PagedServingEngine, ServingEngine

    cfg = LlamaConfig.tiny(vocab_size=256, hidden_size=256,
                           intermediate_size=512, num_attention_heads=4,
                           num_key_value_heads=2)
    net = quantize_for_serving(LlamaForCausalLM(cfg, device=dev, seed=4),
                               inplace=True)
    rng = np.random.RandomState(6)
    prompts = [rng.randint(0, 256, (n,)) for n in (9, 17, 30, 5)]
    wants = [net.generate(p[None], max_new_tokens=10, cache_dtype="int8")
             [0].cpu().numpy() for p in prompts]
    for eng in (PagedServingEngine(net, max_batch_size=2, max_seq_len=64,
                                   page_size=8, min_bucket=8,
                                   cache_dtype="int8"),
                ServingEngine(net, max_batch_size=2, max_seq_len=64,
                              min_bucket=8, cache_dtype="int8")):
        handles = [eng.submit(p, 10) for p in prompts]
        eng.run_until_idle()
        for h, want in zip(handles, wants):
            np.testing.assert_array_equal(h.output_ids, want)
        assert eng.pool.occupancy == 0


NORM_MATMUL_CASES = {
    # rows, K, N, the norm weight in fp32 (else in x's dtype), tolerance:
    # fp32: the narrow kernel with three K chunks (the last ragged) and
    # the wide one over a ragged tile; bf16: the swap-AB kernel (K not a
    # multiple of the 64-row k-tile, N not of the 128-column tile) and
    # the tiled one over a ragged row tile; then the 7B decode and
    # prefill heads (256 rows: the largest swap-AB tile; 1024: tiled)
    "narrow": (3, 1040, 200, False, 1e-5),
    "wide_fp32_w": (130, 520, 136, True, 1e-5),
    "tiled_ragged": (300, 520, 136, True, 1e-5),
    "7b_decode": (8, 4096, 32000, False, 1e-4),
    "7b_prefill": (256, 4096, 32000, True, 1e-4),
    "7b_prefill_1024": (1024, 4096, 32000, False, 1e-4),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(NORM_MATMUL_CASES))
def test_rms_norm_matmul_kernel(dev, dtype, case):
    rows, k, n, w32, tol = NORM_MATMUL_CASES[case]
    dt = DTYPES[dtype]
    g = torch.Generator(device=dev).manual_seed(rows + k)
    x = torch.randn(rows, k, generator=g, device=dev).to(dt)
    w = (1 + 0.1 * torch.randn(k, generator=g, device=dev)).to(
        torch.float32 if w32 else dt)
    wm = (0.02 * torch.randn(k, n, generator=g, device=dev)).to(dt)
    counter = f"{tfnm.design(dt, rows)}_launches"
    before = tfnm.launches, getattr(tfnm, counter)
    y = tfnm.rms_norm_matmul(x, w, wm, 1e-5)
    assert (tfnm.launches, getattr(tfnm, counter)) \
        == (before[0] + 1, before[1] + 1)
    ref = tfnm.rms_norm_matmul_reference(x, w, wm, 1e-5).float()
    assert y.dtype == dt and y.shape == (rows, n)
    assert torch.isfinite(y).all()
    # cast once, plus what the kernel's own rstd may move the rounding of
    # the normed row by (zero in fp32)
    top = float(ref.abs().max())
    bound = (tol * top if dt == torch.float32
             else 2.0 ** -7 * ref.abs() + tol * top)
    bound = bound + tfnm.normed_rounding_slack(x, w, wm, 1e-5)
    assert bool(((y.float() - ref).abs() <= bound).all())
    # no atomics: a second run is bit-equal
    assert torch.equal(y, tfnm.rms_norm_matmul_cuda(x, w, wm, 1e-5))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["swap", "tiled"])
@pytest.mark.parametrize("rows", [8, 64, 256])
def test_rms_norm_matmul_each_kernel(dev, kernel, rows):
    """Each bf16 tensor-core kernel by name at the rows the crossover
    sweep visits: within cast-once plus the rounding slack, bit-equal on
    repeat."""
    g = torch.Generator(device=dev).manual_seed(rows)
    k, n = 1040, 264
    x = torch.randn(rows, k, generator=g, device=dev).bfloat16()
    w = (1 + 0.1 * torch.randn(k, generator=g, device=dev)).bfloat16()
    wm = (0.02 * torch.randn(k, n, generator=g, device=dev)).bfloat16()
    y = tfnm._tc_kernel(x, w, wm, 1e-5, kernel)
    ref = tfnm.rms_norm_matmul_reference(x, w, wm, 1e-5).float()
    bound = 2.0 ** -7 * ref.abs() + 1e-5 * float(ref.abs().max()) \
        + tfnm.normed_rounding_slack(x, w, wm, 1e-5)
    assert bool(((y.float() - ref).abs() <= bound).all())
    assert torch.equal(y, tfnm._tc_kernel(x, w, wm, 1e-5, kernel))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 8, 17, 130, 300])
@pytest.mark.parametrize("k", [520, 1040])
def test_rms_norm_matmul_split_kernel(dev, rows, k):
    """The fp32 split design by name at every row count (rows not a
    multiple of 8 or of the 128-row tile, K not a multiple of the 32-row
    k-tile, N not of the 256-column tile): within 1e-5 of the largest
    entry, bit-equal on repeat, and level with the CUDA-core kernels
    within the same tolerance."""
    g = torch.Generator(device=dev).manual_seed(rows * k)
    n = 264
    x = torch.randn(rows, k, generator=g, device=dev)
    w = 1 + 0.1 * torch.randn(k, generator=g, device=dev)
    wm = 0.02 * torch.randn(k, n, generator=g, device=dev)
    before = tfnm.split_launches
    y = tfnm._split_kernel(x, w, wm, 1e-5)
    assert tfnm.split_launches == before + 1
    ref = tfnm.rms_norm_matmul_reference(x, w, wm, 1e-5)
    assert y.dtype == torch.float32 and y.shape == (rows, n)
    assert _rel_ok(y, ref, 1e-5)
    assert torch.equal(y, tfnm._split_kernel(x, w, wm, 1e-5))
    cc = tfnm.rms_norm_matmul_cuda(x, w, wm, 1e-5, cuda_cores=True)
    assert _rel_ok(y, cc, 1e-5)


@pytest.mark.cuda
def test_rms_norm_matmul_grads_and_refusals(dev):
    g = torch.Generator(device=dev).manual_seed(3)
    x, w, wm = (torch.randn(*sh, generator=g, device=dev).requires_grad_(True)
                for sh in ((2, 5, 64), (64,), (64, 48)))
    y = tfnm.rms_norm_matmul(x, w, wm)
    assert y.shape == (2, 5, 48)
    gy = torch.randn(2, 5, 48, generator=g, device=dev)
    got = torch.autograd.grad(y, (x, w, wm), gy)
    want = torch.autograd.grad(tfnm.rms_norm_matmul_reference(x, w, wm),
                               (x, w, wm), gy)
    for a, b in zip(got, want):
        assert torch.equal(a, b)  # the backward IS the plain version's
    x, w, wm = x.detach(), w.detach(), wm.detach()
    with pytest.raises(TypeError, match="one dtype"):
        tfnm.rms_norm_matmul_cuda(x.bfloat16(), w, wm)
    with pytest.raises(TypeError, match="one dtype"):
        tfnm.rms_norm_matmul_cuda(x, w.bfloat16(), wm)
    with pytest.raises(ValueError, match="multiples of 8"):
        tfnm.rms_norm_matmul_cuda(x, w, wm[:, :44].contiguous())


ROPE_ATTENTION_CASES = {
    # causal, S, head_dim, tolerance, strided q/k/v views: a ragged tail,
    # non-causal, views of one fused projection, the 7B training shape's
    # sequence
    "causal_ragged": (True, 130, 128, 1e-5, False),
    "full_d64": (False, 100, 64, 1e-5, False),
    "causal_strided": (True, 96, 64, 1e-5, True),
    "causal_2048": (True, 2048, 128, 1e-4, False),
    "causal_d16": (True, 130, 16, 1e-5, False),
    "full_d32": (False, 100, 32, 1e-5, False),
    "causal_d256": (True, 130, 256, 1e-5, False),
    # padded to the 128-wide kernel: column c pairs with c + d/2
    "causal_d80": (True, 130, 80, 1e-5, False),
    "full_d96": (False, 100, 96, 1e-5, False),
    # not multiples of 16: each half zero-padded by the wrapper (72 to
    # the tensor cores at 80 in bf16, 40 to the split design at 48)
    "causal_d72": (True, 130, 72, 1e-5, False),
    "full_d40": (False, 100, 40, 1e-5, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(ROPE_ATTENTION_CASES))
def test_rope_attention_kernel(dev, dtype, case):
    causal, s, d, tol, strided = ROPE_ATTENTION_CASES[case]
    dt = DTYPES[dtype]
    q, k, v, _ = _flash_inputs(dev, dt, 1, s, s, 4, d, seed=s + d,
                               strided=strided)
    # leading rows of a longer table, as the model passes them
    cos, sin = trope.build_rope_cache(s + 64, d, device=dev)
    cos, sin = cos[:, :s], sin[:, :s]
    design = tfra.design(dt, d)
    before = tfra.launches, getattr(tfra, f"{design}_launches")
    o = tfra.rope_attention_fused(q, k, v, cos, sin, causal=causal)
    assert (tfra.launches, getattr(tfra, f"{design}_launches")) == (
        before[0] + 1, before[1] + 1)
    padded = -(-d // 16) * 16
    assert design == ("tc" if dt == torch.bfloat16 and 64 <= padded <= 128
                      else "split")
    ref = tfra.rope_attention_reference(q, k, v, cos, sin, causal=causal)
    assert o.dtype == dt and o.shape == q.shape and torch.isfinite(o).all()
    # the tensor-core kernel's split products: their own slack
    slack = (tfra.split_product_slack(q, k, v, cos, sin, causal=causal)
             if design == "tc" else None)
    assert _cast_once_ok(o, ref, tol, slack)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("d", [16, 72, 128, 256])
def test_rope_attention_backward_composes_the_kernels(dev, dtype, d):
    """The fused backward on the card: one rope and one rope-backward
    launch, one flash forward and one flash backward (the tensor-core
    design), counted once as the composition; its gradients against the
    plain VJP (autograd through the plain forward on the card) within the
    flash backward's tolerance, and bit for bit on a repeat."""
    from paddle_tpu_torch import kernels

    dt = DTYPES[dtype]
    s = 130
    q, k, v, g = _flash_inputs(dev, dt, 2, s, s, 3, d, seed=d + 7)
    cos, sin = trope.build_rope_cache(s, d, device=dev)

    def grads(fn):
        ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
        return torch.autograd.grad(fn(*ins), ins, g)

    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = tfra.rope_attention_fused(*ins, cos, sin)
    kernels.reset_launch_counts()
    got = torch.autograd.grad(o, ins, g)
    counts = kernels.launch_counts()
    want_counts = dict.fromkeys(kernels.KERNELS, 0)
    want_counts.update(rope=1, rope_bwd=1, flash_attention_fwd=1,
                       flash_attention_bwd=1, rope_attention_bwd=1)
    assert counts == want_counts
    assert kernels.flash_design_counts() == {
        "tc_launches": 1, "tc_bwd_launches": 1, "cc_launches": 0,
        "cc_bwd_launches": 0}
    again = grads(lambda *ins: tfra.rope_attention_fused(*ins, cos, sin))
    plain = grads(lambda *ins: tfra.rope_attention_reference(*ins, cos, sin))
    for a, b, w in zip(got, again, plain):
        assert a.dtype == dt and torch.isfinite(a).all()
        assert torch.equal(a, b)
        assert _cast_once_ok(a, w, 1e-4)


@pytest.mark.cuda
def test_rope_attention_refuses_what_it_does_not_take(dev):
    """Head dims 80 and 72 run and match their plain versions; 272 is
    refused naming ROADMAP.md queue C item 1."""
    for d in (80, 72):
        q = torch.randn(1, 8, 2, d, device=dev)
        cos, sin = trope.build_rope_cache(8, d, device=dev)
        assert _cast_once_ok(tfra.rope_attention_cuda(q, q, q, cos, sin),
                             tfra.rope_attention_reference(q, q, q, cos,
                                                           sin), 1e-5)
    q = torch.randn(1, 8, 2, 272, device=dev)
    cos, sin = trope.build_rope_cache(8, 272, device=dev)
    with pytest.raises(ValueError,
                       match="head_dim.*ROADMAP.md queue C item 1"):
        tfra.rope_attention_cuda(q, q, q, cos, sin)
    q = torch.randn(1, 8, 2, 64, device=dev)
    cos, sin = trope.build_rope_cache(8, 64, device=dev)
    with pytest.raises(TypeError, match="one dtype"):
        tfra.rope_attention_cuda(q, q.bfloat16(), q, cos, sin)
    with pytest.raises(TypeError, match="float32 tables"):
        tfra.rope_attention_cuda(q, q, q, cos.bfloat16(), sin.bfloat16())
    with pytest.raises(ValueError, match="self-attention"):
        tfra.rope_attention_cuda(q, q[:, :4], q[:, :4], cos, sin)


@pytest.mark.cuda
def test_tiny_fused_model_matches_cpu(dev):
    """Both fusions on the card (head_dim 64): the cache-free logits
    against the same model on the CPU, 2e-5 absolute + 1e-4 relative;
    greedy streams equal to the unfused ones."""
    from paddle_tpu_torch.convert import load_numpy_state, numpy_state
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.tiny(vocab_size=256, hidden_size=256,
                           intermediate_size=512, num_attention_heads=4)
    both = ("rms_norm_matmul", "rope_attention")
    cpu = LlamaForCausalLM(cfg, device="cpu", seed=4, fusions=both)
    net = LlamaForCausalLM(cfg, device=dev, fusions=both)
    load_numpy_state(net, numpy_state(cpu))
    ids = np.random.RandomState(7).randint(0, 256, (2, 40))
    with torch.inference_mode():
        want = cpu(torch.as_tensor(ids))
        before = (tfnm.launches, tfra.launches)
        got = net(torch.as_tensor(ids, device=dev))
        assert (tfnm.launches, tfra.launches) == (
            before[0] + 1, before[1] + cfg.num_hidden_layers)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.numpy(),
                               atol=2e-5, rtol=1e-4)
    fused = net.generate(ids[:, :9], max_new_tokens=8, cache_dtype="float32")
    net.fusions = ()
    plain = net.generate(ids[:, :9], max_new_tokens=8, cache_dtype="float32")
    assert torch.equal(fused, plain)


@pytest.mark.cuda
def test_tiny_default_model_on_the_card(dev):
    """``LlamaConfig.tiny()`` at its default head_dim 16, fp32: the
    cache-free logits (flash at D 16) against the CPU, 2e-5 absolute +
    1e-4 relative; one AdamW train step (flash backward at D 16): loss
    within 1e-5 relative and every parameter within 1e-5 absolute of the
    CPU's; the paged engine's greedy streams (paged attention at D 16)
    equal to the same engine's on the CPU."""
    from paddle_tpu_torch.convert import load_numpy_state, numpy_state
    from paddle_tpu_torch.jit import CompiledTrainStep
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         causal_lm_loss)
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.serving import PagedServingEngine

    cfg = LlamaConfig.tiny()
    assert cfg.hidden_size // cfg.num_attention_heads == 16
    weights = numpy_state(LlamaForCausalLM(cfg, device="cpu", seed=21))
    rng = np.random.RandomState(22)
    ids = rng.randint(0, cfg.vocab_size, (2, 41))

    def built(device):
        net = LlamaForCausalLM(cfg, device=device, dtype=torch.float32)
        load_numpy_state(net, weights)
        return net

    def step(net, device):
        opt = AdamW(1e-3, epsilon=1e-3, parameters=net.named_parameters())
        train = CompiledTrainStep(
            net, lambda lo, lb: causal_lm_loss(lo, lb).mean(), opt)
        t = torch.as_tensor(ids, dtype=torch.long, device=device)
        loss, _ = train([t[:, :-1]], [t[:, 1:]])
        return float(loss), numpy_state(net)

    def streams(net):
        eng = PagedServingEngine(net, max_batch_size=2, max_seq_len=64,
                                 page_size=8, min_bucket=8,
                                 cache_dtype="float32")
        hs = [eng.submit(p, 8) for p in (ids[0, :9], ids[1, :20], ids[0])]
        eng.run_until_idle()
        return [h.output_ids.tolist() for h in hs]

    loss_card, after_card = step(built(dev), dev)
    loss_cpu, after_cpu = step(built("cpu"), "cpu")
    cpu, card = built("cpu"), built(dev)
    with torch.inference_mode():
        want = cpu(torch.as_tensor(ids)).numpy()
        got = card(torch.as_tensor(ids, device=dev)).float().cpu().numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)
    assert streams(card) == streams(cpu)
    assert abs(loss_card - loss_cpu) <= 1e-5 * abs(loss_cpu)
    for name, w in after_cpu.items():
        np.testing.assert_allclose(after_card[name], w, atol=1e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("cache", ["bfloat16", "int8"])
@pytest.mark.parametrize("kind", ["paged", "slab"])
def test_decode_program_replays_equal_eager_step(dev, kind, cache):
    """A tiny bf16 Llama's decode program (a CUDA graph) against the
    eager step over a copy of the same caches: bit-equal logits and
    caches at its capture and at 3 replays at other positions (and page
    tables), and each replay counts the launches of one eager step."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.models.generation import decode_step
    from paddle_tpu_torch.quantization.kv import QuantizedKV, is_quantized
    from paddle_tpu_torch.serving import PagedServingEngine, ServingEngine

    cfg = LlamaConfig.tiny(vocab_size=256, hidden_size=256,
                           intermediate_size=512, num_hidden_layers=2,
                           num_attention_heads=4, num_key_value_heads=2)
    net = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16, seed=2)
    kw = dict(max_batch_size=4, max_seq_len=64, min_bucket=8,
              cache_dtype=cache)
    eng = (PagedServingEngine(net, page_size=8, **kw) if kind == "paged"
           else ServingEngine(net, **kw))
    gen = torch.Generator(device=dev).manual_seed(0)

    def fill(t):
        if is_quantized(t):
            t.q.copy_(torch.randint(-127, 128, t.q.shape, generator=gen,
                                    device=dev, dtype=torch.int32))
            t.scale.copy_(torch.rand(t.scale.shape, generator=gen,
                                     device=dev) * 0.02)
        else:
            t.copy_(torch.randn(t.shape, generator=gen, device=dev))

    def clone(t):
        return (QuantizedKV(t.q.clone(), t.scale.clone())
                if is_quantized(t) else t.clone())

    def same(a, b):
        return (torch.equal(a.q, b.q) and torch.equal(a.scale, b.scale)
                if is_quantized(a) else torch.equal(a, b))

    for pair in eng._caches:
        for t in pair:
            fill(t)
    twin = [tuple(clone(t) for t in pair) for pair in eng._caches]
    rng = np.random.RandomState(3)
    for call in range(4):  # the capture, then 3 replays
        tok = rng.randint(0, 256, (4, 1)).astype(np.int64)
        pos = rng.randint(0, 64, (4,)).astype(np.int32)
        arrays = [tok, pos]
        extra = {}
        if kind == "paged":
            table = rng.permutation(np.arange(1, eng.page_pool.num_pages
                                              + 1))[:32].reshape(4, 8)
            arrays.append(table.astype(np.int32))
            extra["page_table"] = torch.from_numpy(arrays[2]).to(dev)
        with torch.inference_mode():
            kernels.reset_launch_counts()
            want, _ = decode_step(net, torch.from_numpy(tok).to(dev), twin,
                                  torch.from_numpy(pos).to(dev), **extra)
            eager_counts = kernels.launch_counts()
            kernels.reset_launch_counts()
            got, greedy = eng._programs.run(("decode",), eng._build_decode,
                                            *arrays)
            counts = kernels.launch_counts()
        torch.cuda.synchronize()
        assert torch.equal(got, want), call
        assert torch.equal(greedy, want.argmax(dim=-1))
        assert counts == eager_counts and counts["rms_norm"] == 5, call
        for pair, tw in zip(eng._caches, twin):
            assert all(same(a, b) for a, b in zip(pair, tw)), call
    assert eng.compile_counts()["serving::decode_step"] == 1


@pytest.mark.cuda
def test_capture_runs_without_collecting_dead_graphs(dev):
    """An engine dropped in a reference cycle keeps its graphs until a
    collection; one during another engine's capture would destroy them
    inside it, which the capture does not permit. Captures run with
    automatic collection off: a body whose allocations would trigger one
    captures all the same."""
    import gc

    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import PagedServingEngine

    cfg = LlamaConfig.tiny(vocab_size=256, hidden_size=256,
                           intermediate_size=512, num_hidden_layers=1,
                           num_attention_heads=4)
    net = LlamaForCausalLM(cfg, device=dev, dtype=torch.float32, seed=2)
    kw = dict(max_batch_size=2, max_seq_len=32, min_bucket=8, page_size=8,
              cache_dtype="float32")
    dead = PagedServingEngine(net, **kw)
    dead.warmup()
    dead.cycle = dead  # only a collection frees it now
    del dead
    eng = PagedServingEngine(net, **kw)
    build, enabled = eng._build_decode, []

    def build_collecting():
        body, inputs, keep = build()

        def collecting(*args, **kwargs):
            enabled.append(gc.isenabled())
            threshold = gc.get_threshold()
            gc.set_threshold(1)
            try:
                _ = [[] for _ in range(1000)]  # a collection, if enabled
                return body(*args, **kwargs)
            finally:
                gc.set_threshold(*threshold)

        return collecting, inputs, keep

    eng._build_decode = build_collecting
    assert eng.warmup()["programs"] == 1 + 2 * len(eng._warmup_buckets())
    assert enabled == [True, False]  # the warm run, then the capture
    h = eng.submit(np.arange(1, 12), 6)
    eng.run_until_idle()
    want = net.generate(np.arange(1, 12)[None], max_new_tokens=6,
                        cache_dtype="float32")
    assert h.output_ids.tolist() == want[0].tolist()
    gc.collect()


def _prefix_net(dev, dtype):
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.tiny(vocab_size=256, hidden_size=256,
                           intermediate_size=512, num_hidden_layers=2,
                           num_attention_heads=4, num_key_value_heads=2)
    return LlamaForCausalLM(cfg, device=dev, dtype=dtype, seed=2)


def _prefix_traffic(eng, rng):
    """Two first turns over a 20-token prefix; then another tail, the
    first 19 prefix tokens (a clone) and a second turn over the first
    answer. Returns the handles."""
    prefix = rng.randint(0, 256, (20,))
    hs = [eng.submit(np.concatenate([prefix, rng.randint(0, 256, (4,))]), 6)
          for _ in range(2)]
    eng.run_until_idle()
    hs += [eng.submit(p, 6) for p in (
        np.concatenate([prefix, rng.randint(0, 256, (4,))]), prefix[:19],
        np.concatenate([hs[0].output_ids, rng.randint(0, 256, (3,))]))]
    eng.run_until_idle()
    assert all(h.status == "DONE" for h in hs)
    return hs


@pytest.mark.cuda
@pytest.mark.parametrize("cache", ["bfloat16", "int8"])
def test_warm_admissions_replay_equal_eager(dev, cache):
    """A tiny bf16 Llama's prefix engine through its programs (gather,
    chunk prefill and adopt as CUDA graphs, captured by ``warmup()``)
    against the same engine stepping eagerly: equal streams and
    counters, and every arena page but the garbage page bit-equal (the
    same pages are claimed in the same order); nothing is captured
    during traffic."""
    from paddle_tpu_torch.quantization.kv import is_quantized
    from paddle_tpu_torch.serving import PagedServingEngine

    net = _prefix_net(dev, torch.bfloat16)
    kw = dict(max_batch_size=2, max_seq_len=64, min_bucket=8, page_size=8,
              cache_dtype=cache, prefix_cache=True)
    graphs = PagedServingEngine(net, **kw)
    graphs.warmup()
    captures = graphs.compile_counts()
    eager = PagedServingEngine(net, graphs=False, **kw)
    hg = _prefix_traffic(graphs, np.random.RandomState(5))
    he = _prefix_traffic(eager, np.random.RandomState(5))
    assert [h.tokens for h in hg] == [h.tokens for h in he]
    st = graphs.prefix_cache.stats()
    assert st == eager.prefix_cache.stats()
    assert st["hits"] == 4 and st["cow_clones"] >= 1
    assert graphs.compile_counts() == captures
    for pg, pe in zip(graphs._caches, eager._caches):
        for a, b in zip(pg, pe):
            for x, y in (((a.q, b.q), (a.scale, b.scale))
                         if is_quantized(a) else ((a, b),)):
                assert torch.equal(x[1:], y[1:])
    for eng in (graphs, eager):
        eng.close()
        assert eng.page_pool.pages_in_use == 0


@pytest.mark.cuda
def test_chunk_capture_serves_every_start(dev):
    """One chunk-prefill program, captured by ``warmup()`` at start 0,
    replayed at starts 12 and 16 over a block gathered from arena pages:
    each replay equals the eager chunk body at that start bit for bit
    and the full prefill's logits row within 1e-5 of its largest entry
    (fp32 products at another row count); a start frozen into the graph
    would give another row."""
    from paddle_tpu_torch.models.generation import alloc_kv_caches
    from paddle_tpu_torch.quantization.kv import adopt_into_pages
    from paddle_tpu_torch.serving import KVBlock, PagedServingEngine

    net = _prefix_net(dev, torch.float32)
    eng = PagedServingEngine(net, max_batch_size=2, max_seq_len=64,
                             min_bucket=8, page_size=8,
                             cache_dtype="float32", prefix_cache=True)
    eng.warmup()
    ids = torch.from_numpy(np.random.RandomState(6).randint(0, 256, (28,)))
    full = torch.zeros((1, 32), dtype=torch.long, device=dev)
    full[0, :28] = ids
    with torch.inference_mode():
        ref = alloc_kv_caches(net.config, 1, 32, "float32", device=dev)
        want = net(full, caches=ref, pos=0)[0][0, 27]
        pages = torch.tensor([3, 1, 4, 2], device=dev)
        for (ak, av), (rk, rv) in zip(eng._caches, ref):
            adopt_into_pages(ak, rk, pages, 4, 8)
            adopt_into_pages(av, rv, pages, 4, 8)
        for c in (12, 16):
            src = np.zeros((4,), np.int64)
            src[:-(-c // 8)] = pages.cpu().numpy()[:-(-c // 8)]
            tail = np.zeros((1, 16), np.int64)
            tail[0, :28 - c] = ids.numpy()[c:]
            pos = np.array([c], np.int32)
            # the programs warmup() captured over the bucket's one block
            blk = eng.pool.alloc(28)
            try:
                eng._programs.run(("gather", 32), None, src)
                got = eng._programs.run(("chunk", 32, 16), None, tail,
                                        pos)[0, 27 - c].clone()
            finally:
                eng.pool.free(blk)
            twin = KVBlock(32, alloc_kv_caches(net.config, 1, 32, "float32",
                                               device=dev))
            eng._gather_body(twin)(torch.from_numpy(src).to(dev))
            eager = eng._chunk_body(twin)(
                torch.from_numpy(tail).to(dev),
                torch.from_numpy(pos).to(dev))[0, 27 - c]
            torch.cuda.synchronize()
            assert torch.equal(got, eager), c
            tol = 1e-5 * float(want.abs().max())
            assert float((got - want).abs().max()) <= tol, c
    assert eng.compile_counts()["serving::chunk_prefill"] == 10
    eng.close()


@pytest.mark.cuda
@pytest.mark.parametrize("cache", ["bfloat16", "int8"])
def test_verify_replay_equals_eager_at_every_pos(dev, cache):
    """One slab verify program ``("spec_verify", 64, 4)``, captured by
    ``warmup()``, replayed at positions 12 and 20 over a block holding a
    28-token prefill: each replay's logits and written block are bit-equal
    to the eager verify body at that position (the same kernels on the
    same inputs), and nothing is captured again."""
    from paddle_tpu_torch.quantization.kv import is_quantized
    from paddle_tpu_torch.serving import ServingEngine, SpeculativeDecoder
    from paddle_tpu_torch.serving.speculative import build_verify_body

    def leaves(caches):
        return [x for pair in caches for t in pair
                for x in ((t.q, t.scale) if is_quantized(t) else (t,))]

    net = _prefix_net(dev, torch.bfloat16)
    spec = SpeculativeDecoder(exit_layer=1, k=3)
    eng = ServingEngine(net, max_batch_size=2, max_seq_len=64, min_bucket=8,
                        cache_dtype=cache, speculative=spec)
    eng.warmup()
    captures = eng.compile_counts()
    rng = np.random.RandomState(7)
    full = torch.zeros((1, 64), dtype=torch.long, device=dev)
    full[0, :28] = torch.from_numpy(rng.randint(0, 256, (28,)))
    blk = eng.pool.alloc(64)
    try:
        with torch.inference_mode():
            net(full, caches=blk.caches, pos=0)
            start = [x.clone() for x in leaves(blk.caches)]
            eager_body = build_verify_body(net, blk.caches, 4,
                                           cache == "int8")
            for p in (12, 20):
                ids = rng.randint(0, 256, (1, 4))
                pos = np.array([p], np.int32)
                for x, y in zip(leaves(blk.caches), start):
                    x.copy_(y)
                got = eng._programs.run(("spec_verify", 64, 4), None, ids,
                                        pos).clone()
                got_block = [x.clone() for x in leaves(blk.caches)]
                for x, y in zip(leaves(blk.caches), start):
                    x.copy_(y)
                want = eager_body(torch.from_numpy(ids).to(dev),
                                  torch.from_numpy(pos).to(dev))
                torch.cuda.synchronize()
                assert torch.equal(got, want), p
                assert all(torch.equal(a, b) for a, b in zip(
                    got_block, leaves(blk.caches))), p
    finally:
        eng.pool.free(blk)
    assert eng.compile_counts() == captures
    eng.close()


@pytest.mark.cuda
@pytest.mark.parametrize("cache,rows", [
    ("bfloat16", 4), ("int8", 4), ("bfloat16", 2)])
def test_paged_verify_rows_equal_vanilla_rows_on_card(dev, cache, rows):
    """The paged verify (replays of the decode program, CUDA graphs) on
    the card: every verify row scored with a stream's own tokens equals
    the vanilla paged engine's decode row at that position bit for bit,
    also with k + 1 above the rows (consecutive replays); the streams are
    equal and the pool drains after the rollbacks."""
    from paddle_tpu_torch.serving import (PagedServingEngine,
                                          SpeculativeDecoder)

    net = _prefix_net(dev, torch.bfloat16)
    kw = dict(max_batch_size=rows, max_seq_len=64, min_bucket=8,
              page_size=4, cache_dtype=cache, demand_paging=True)
    prompts = list(np.random.RandomState(17).randint(0, 256, (2, 7)))
    vanilla = PagedServingEngine(net, **kw)
    vanilla.warmup()
    van_rows = {}
    run = vanilla._programs.run

    def recording_run(key, build, *arrays):
        out = run(key, build, *arrays)
        if key == ("decode",):
            for i, seq in enumerate(vanilla._seqs):
                if seq is not None:
                    van_rows[(seq.handle.request.request_id,
                              int(arrays[1][i]))] = out[0][i].clone()
        return out

    vanilla._programs.run = recording_run
    van = vanilla.generate(prompts, max_new_tokens=12)
    want = [h.tokens for h in van]
    eng = PagedServingEngine(net, speculative=SpeculativeDecoder(
        exit_layer=1, k=3), **kw)
    eng.warmup()
    verify, rec = eng._spec_verify, []

    def recording_verify(slot, ids, pos):
        out = verify(slot, ids, pos)
        rid = eng._seqs[slot].handle.request.request_id
        rec.extend((rid, pos + i, tuple(ids[0, :i + 1]), out[i].clone())
                   for i in range(ids.shape[1]))
        return out

    eng._spec_verify = recording_verify
    hs = eng.generate(prompts, max_new_tokens=12)
    assert [h.tokens for h in hs] == want
    # request ids -> prompt index, in each engine
    spec_j = {h.request.request_id: j for j, h in enumerate(hs)}
    van_id = [h.request.request_id for h in van]
    compared = 0
    for rid, q, ctx, row in rec:
        j = spec_j[rid]
        stream = list(prompts[j]) + want[j]
        p = q - len(ctx) + 1
        if q + 1 < len(stream) and tuple(stream[p:q + 1]) == ctx:
            assert torch.equal(row, van_rows[(van_id[j], q)]), (j, q)
            compared += 1
    assert compared >= 10
    for e in (eng, vanilla):
        e.close()
        assert e.page_pool.pages_in_use == 0


@pytest.mark.cuda
@pytest.mark.parametrize("cache", ["bfloat16", "int8"])
def test_tier_round_trip_bit_equal_on_card(dev, cache):
    """A prefix engine with a host spill tier on the card: its cached
    pages spilled (read to the host, framed) and restored by a chain walk
    (the adopt program writes them into fresh pages) land bit-equal, and
    a warm request over them runs to its end."""
    from paddle_tpu_torch.quantization.kv import is_quantized
    from paddle_tpu_torch.serving import PagedServingEngine

    def page(eng, p):
        return [x[p].clone() for pair in eng._caches for t in pair
                for x in ((t.q, t.scale) if is_quantized(t) else (t,))]

    net = _prefix_net(dev, torch.bfloat16)
    kw = dict(max_batch_size=2, max_seq_len=64, min_bucket=8, page_size=8,
              cache_dtype=cache)
    eng = PagedServingEngine(net, prefix_cache=True, kv_tiering=True, **kw)
    eng.warmup()
    prompt = np.random.RandomState(9).randint(0, 256, (26,))
    (h,) = eng.generate([prompt], max_new_tokens=6)
    toks, pc = h.output_ids, eng.prefix_cache
    m = pc.match(toks, 31, eng.weights_version)
    assert m.covered == 31
    before = [page(eng, p) for p in m.pages]
    assert pc.evict(100) == len(before)
    m = pc.match(toks, 31, eng.weights_version)
    assert m.covered == 31
    assert eng.kv_tier.stats()["restores"] == {"host": len(before)}
    for p, want in zip(m.pages, before):
        assert all(torch.equal(a, b) for a, b in zip(page(eng, p), want))
    cold = PagedServingEngine(net, **kw)
    follow = np.concatenate([toks, [5, 6, 7]])
    (warm,) = eng.generate([follow], max_new_tokens=4)
    assert pc.stats()["hits"] == 1
    assert warm.status == "DONE" and len(warm.tokens) == 4
    (ref,) = cold.generate([follow], max_new_tokens=4)
    assert len(ref.tokens) == 4
    for e in (eng, cold):
        e.close()
        assert e.page_pool.pages_in_use == 0


def _mt_lists(dev, dtype, seed):
    """Odd sizes, an empty tensor and an unaligned slice (one element
    into its storage): parameters and gradients in ``dtype``, fp32
    moments."""
    g = torch.Generator(device=dev).manual_seed(seed)
    shapes = ((1,), (7,), (1023,), (64, 33), (0,), (5000,))

    def make(dt, scale=1.0, positive=False):
        xs = []
        for s in shapes:
            x = torch.randn(s, generator=g, device=dev) * scale
            xs.append((x.abs() if positive else x).to(dt))
        xs[-1] = xs[-1][1:]
        return xs

    return (make(dtype), make(dtype, 2.0), make(torch.float32, 0.1),
            make(torch.float32, 0.1, positive=True))


def _clone(*cols):
    return [[x.clone() for x in c] for c in cols]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_multi_tensor_updates_equal_plain_bitwise(dev, dtype):
    ps, gs, ms, vs = _mt_lists(dev, DTYPES[dtype], 31)
    inv = torch.full((), 0.5, device=dev)
    stats = tfad.grad_sumsq(gs, inv=inv, clip_norm=1.0, skip_nonfinite=True)
    for pro, l1 in ((None, 0.0),
                    (tfad.Prologue(inv, tfad.CLIP_GLOBAL, stats,
                                   skip=True), 0.0),
                    (tfad.Prologue(None, tfad.CLIP_NORM, stats,
                                   clip_norm=0.3), 0.01),
                    (tfad.Prologue(None, tfad.CLIP_VALUE, lo=-0.1, hi=0.2),
                     0.0)):
        for decoupled in (False, True):
            a, b = _clone(ps, ms, vs), _clone(ps, ms, vs)
            kw = dict(lr=1e-2, beta1=0.9, beta2=0.999, eps=1e-8, t=2,
                      decoupled=decoupled, weight_decay=0.01, l1=l1,
                      prologue=pro)
            tfad.fused_adam_update(a[0], a[1], a[2], gs, **kw)
            tfad.fused_adam_update_reference(b[0], b[1], b[2], gs, **kw)
            for x, y in zip(sum(a, []), sum(b, [])):
                assert torch.equal(x, y)
        a, b = _clone(ps, ms), _clone(ps, ms)
        kw = dict(lr=0.1, momentum=0.9, use_nesterov=True,
                  weight_decay=0.0 if l1 else 0.01, l1=l1, prologue=pro)
        tfad.momentum_update(a[0], a[1], gs, **kw)
        tfad.momentum_update_reference(b[0], b[1], gs, **kw)
        for x, y in zip(sum(a, []), sum(b, [])):
            assert torch.equal(x, y)


@pytest.mark.cuda
def test_multi_tensor_sums_lamb_and_skip(dev):
    from paddle_tpu_torch import kernels

    ps, gs, ms, vs = _mt_lists(dev, torch.float32, 32)
    kernels.reset_launch_counts()
    stats = tfad.grad_sumsq(gs, clip_norm=1.0)
    assert torch.equal(stats.buf, tfad.grad_sumsq(gs, clip_norm=1.0).buf)
    ref = tfad.grad_sumsq_reference(gs, clip_norm=1.0)
    k = 4 + len(gs)
    torch.testing.assert_close(stats.buf[:k], ref.buf[:k], rtol=1e-6,
                               atol=0)
    a, b = _clone(ps, ms, vs), _clone(ps, ms, vs)
    kw = dict(lr=1e-2, beta1=0.9, beta2=0.999, eps=1e-6, t=1,
              lamb_weight_decay=0.01,
              prologue=tfad.Prologue(None, tfad.CLIP_GLOBAL, stats))
    tfad.lamb_update(a[0], a[1], a[2], gs, **kw)
    tfad.lamb_update_reference(b[0], b[1], b[2], gs, **kw)
    for x, y in zip(a[1] + a[2], b[1] + b[2]):
        assert torch.equal(x, y)
    for x, y, p in zip(a[0], b[0], ps):
        if p.numel():
            assert float((x - y).abs().max()) <= 1e-6 * float(p.abs().max())
    # no norm: the optimizer gives every tensor stats slot 0, and each
    # tensor's Lamb ratio must still be its own
    for pro in (None, tfad.Prologue(None, tfad.CLIP_VALUE, lo=-0.1,
                                    hi=0.2)):
        a, b = _clone(ps, ms, vs), _clone(ps, ms, vs)
        kw = dict(kw, prologue=pro, slots=[0] * len(ps))
        tfad.lamb_update(a[0], a[1], a[2], gs, **kw)
        tfad.lamb_update_reference(b[0], b[1], b[2], gs, **kw)
        for x, y, p in zip(a[0], b[0], ps):
            if p.numel():
                assert float((x - y).abs().max()) \
                    <= 1e-6 * float(p.abs().max())
    # gradients of both dtypes in one list: one pass a dtype
    mixed = [g if i % 2 == 0 else g.to(torch.bfloat16)
             for i, g in enumerate(gs)]
    got = tfad.grad_sumsq(mixed, clip_norm=1.0)
    ref = tfad.grad_sumsq_reference(mixed, clip_norm=1.0)
    torch.testing.assert_close(got.buf[:k], ref.buf[:k], rtol=1e-6, atol=0)
    assert torch.equal(got.buf[k:], ref.buf[k:])
    # a non-finite gradient under a scaler: nothing is written
    bad = [g.clone() for g in gs]
    bad[2][3] = float("nan")
    inv = torch.ones((), device=dev)
    flagged = tfad.grad_sumsq(bad, inv=inv, skip_nonfinite=True)
    assert not flagged.finite()
    a = _clone(ps, ms, vs)
    tfad.fused_adam_update(a[0], a[1], a[2], bad, 1e-2, 0.9, 0.999, 1e-8, 1,
                           prologue=tfad.Prologue(inv, skip=True,
                                                  stats=flagged))
    for x, y in zip(sum(a, []), ps + ms + vs):
        assert torch.equal(x, y)
    # kernels launched: each sum of squares over one dtype's table is 3
    # (chunks, per-tensor sums, finalize), over two dtypes 5; a Lamb table
    # 3; an Adam table 1 (it returns at once on the set skip flag)
    counts = kernels.launch_counts()
    assert (counts["mt_sumsq"], counts["mt_lamb"], counts["mt_adam"]) \
        == (3 + 3 + 5 + 3, 3 * 3, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("clip", ["none", "value", "global"])
def test_lamb_train_step_on_the_card(dev, clip):
    """Two CompiledTrainSteps of the tiny fp32 model with Lamb (one update
    call over every parameter) on the card against the CPU: without a
    norm (no clip, or ClipGradByValue) no sum of squares runs and every
    tensor sits in stats slot 0; loss within 1e-5 relative and every
    parameter within 1e-5 absolute, as the AdamW step above."""
    from paddle_tpu_torch import optimizer as o
    from paddle_tpu_torch.convert import load_numpy_state, numpy_state
    from paddle_tpu_torch.jit import CompiledTrainStep
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         causal_lm_loss)

    cfg = LlamaConfig.tiny()
    weights = numpy_state(LlamaForCausalLM(cfg, device="cpu", seed=23))
    ids = np.random.RandomState(24).randint(0, cfg.vocab_size, (2, 33))
    grad_clip = {"none": None, "value": o.ClipGradByValue(0.05),
                 "global": o.ClipGradByGlobalNorm(1.0)}[clip]

    def run(device):
        net = LlamaForCausalLM(cfg, device=device, dtype=torch.float32)
        load_numpy_state(net, weights)
        opt = o.Lamb(1e-3, 0.01, epsilon=1e-3,
                     parameters=net.named_parameters(), grad_clip=grad_clip)
        train = CompiledTrainStep(
            net, lambda lo, lb: causal_lm_loss(lo, lb).mean(), opt)
        t = torch.as_tensor(ids, dtype=torch.long, device=device)
        losses = [float(train([t[:, :-1]], [t[:, 1:]])[0]) for _ in range(2)]
        return losses, numpy_state(net)

    card, cpu = run(dev), run("cpu")
    for a, b in zip(card[0], cpu[0]):
        assert abs(a - b) <= 1e-5 * abs(b)
    for name, w in cpu[1].items():
        np.testing.assert_allclose(card[1][name], w, atol=1e-5, rtol=0)



@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["greedy", "sampled", "beam"])
def test_generate_program_equals_eager_loop_on_card(dev, mode):
    """``generate``'s program (one CUDA graph of the prefill and the whole
    decode) against ``graphs=False`` on a tiny bf16 net: token for token
    on the capturing call and on a replay, one capture; an in-place
    weight update shows in the next replay without a capture."""
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.models.generation import generate_programs

    net = LlamaForCausalLM(LlamaConfig.tiny(), device=dev,
                           dtype=torch.bfloat16, seed=31)
    ids = torch.as_tensor(np.random.RandomState(32).randint(0, 1000, (2, 9)),
                          device=dev)
    kw = {"greedy": {}, "beam": dict(num_beams=3),
          "sampled": dict(do_sample=True, temperature=0.8, top_p=0.9,
                          seed=7)}[mode]
    kw.update(max_new_tokens=12)
    want = net.generate(ids, graphs=False, **kw)
    for _ in range(2):
        assert torch.equal(net.generate(ids, **kw), want)
    cache = generate_programs(net)
    assert cache.captures == 1
    with torch.no_grad():
        net.lm_head.weight.mul_(-1.0)
    assert torch.equal(net.generate(ids, **kw),
                       net.generate(ids, graphs=False, **kw))
    assert cache.captures == 1


@pytest.mark.cuda
def test_snapshot_under_in_place_updates_on_card(dev, tmp_path):
    """An async save whose snapshot the trainer fences: the update right
    after the save writes the tensors in place while the copies and the
    write run; the committed checkpoint equals a host copy taken at the
    save."""
    from paddle_tpu_torch.checkpoint import (CheckpointManager,
                                             CheckpointPolicy, commit)
    from paddle_tpu_torch.distributed.checkpoint import load_state_dict
    from paddle_tpu_torch.jit import CompiledTrainStep
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         causal_lm_loss)
    from paddle_tpu_torch.optimizer import AdamW

    net = LlamaForCausalLM(LlamaConfig.tiny(), device=dev,
                           dtype=torch.float32, seed=33)
    opt = AdamW(1e-3, parameters=net.named_parameters())
    step = CompiledTrainStep(
        net, lambda lo, lb: causal_lm_loss(lo, lb).mean(), opt)
    mgr = step.attach_checkpoint(CheckpointManager(
        str(tmp_path), policy=CheckpointPolicy(save_every_steps=1,
                                               keep_last_k=5)))
    t = torch.as_tensor(np.random.RandomState(34).randint(0, 1000, (2, 33)),
                        device=dev)
    step([t[:, :-1]], [t[:, 1:]])
    want = {k: v.detach().to("cpu", copy=True)
            for k, v in net.state_dict().items()}
    for _ in range(3):
        step([t[:, :-1]], [t[:, 1:]])
    mgr.close()
    got = {k: torch.zeros_like(v) for k, v in want.items()}
    load_state_dict({"model": got}, commit.step_dir(str(tmp_path), 1))
    for k, v in want.items():
        assert torch.equal(got[k], v), k


@pytest.mark.cuda
def test_reload_swap_keeps_addresses_on_card(dev, tmp_path):
    """A warmed bf16 paged engine reloads a checkpoint of another net:
    streams equal a fresh engine's on that net, the parameters keep their
    addresses and nothing is captured again."""
    from paddle_tpu_torch.checkpoint import CheckpointManager
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import PagedServingEngine

    cfg = LlamaConfig.tiny()
    kw = dict(cache_dtype="bfloat16", max_batch_size=2, max_seq_len=64,
              min_bucket=8, page_size=8)
    other = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16, seed=36)
    mgr = CheckpointManager(str(tmp_path), network=other,
                            async_saves=False)
    mgr.save(1)
    mgr.close()
    prompts = [np.random.RandomState(37).randint(0, 1000, (n,))
               for n in (5, 17)]
    want = [h.tokens for h in PagedServingEngine(other, **kw).generate(
        prompts, 6)]
    net = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16, seed=35)
    eng = PagedServingEngine(net, **kw)
    eng.warmup()
    captures = eng.compile_counts()
    ptrs = [p.data_ptr() for p in net.state_dict(keep_vars=True).values()]
    assert eng.reload_weights(str(tmp_path)).applied
    assert [h.tokens for h in eng.generate(prompts, 6)] == want
    assert eng.compile_counts() == captures
    assert ptrs == [p.data_ptr()
                    for p in net.state_dict(keep_vars=True).values()]


# ------------------------------------------------------------------ fp8
def _fp8_operands(dev, m, n, k, fa, fb, seed=0):
    """fp8 codes ``a [m, k]`` and ``bt [n, k]`` of normal values through
    the plain quantize, and two scales."""
    from paddle_tpu_torch.kernels import fp8_matmul as tf8

    g = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randn(m, k, device=dev, generator=g)
    b = torch.randn(n, k, device=dev, generator=g) * 3
    sa = torch.tensor(0.011, device=dev)
    sb = torch.tensor(0.02, device=dev)
    return (tf8.quantize_reference(a, sa, fa)[0],
            tf8.quantize_reference(b, sb, fb)[0], sa, sb)


@pytest.mark.cuda
@pytest.mark.parametrize("forms", [("e4m3", "e4m3"), ("e5m2", "e4m3"),
                                   ("e4m3", "e5m2")])
@pytest.mark.parametrize("shape", [(256, 384, 2048), (200, 136, 2064),
                                   (129, 77, 2056)])
def test_fp8_gemm_kernel(dev, forms, shape):
    """The three operand forms, every output type, ragged tiles (and a
    K that is no multiple of 16: the wrapper pads it): within the fp32
    summation bound plus half an ulp of the output, bit-equal on a
    repeat. With the fp32 promotion every 128 of K the kernel's sums came
    to 0.74 of the fp32 bound at K 1024 and 0.086 at K 4096 (fp32 out, on
    the H100): the tests keep K at 2048 and more."""
    from paddle_tpu_torch.kernels import fp8_matmul as tf8

    m, n, k = shape
    a, bt, sa, sb = _fp8_operands(dev, m, n, k, *forms)
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        before = tf8.launches
        out = tf8.gemm(a, bt, sa, sb, dtype)
        assert tf8.launches == before + 1 and out.dtype == dtype
        err, tol, over = tf8.gemm_error(out, a, bt, sa, sb)
        assert over <= 1.0, (dtype, err, tol, over)
        assert torch.equal(out, tf8.gemm(a, bt, sa, sb, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_fp8_quantize_kernel(dev, fmt, dtype):
    """Codes bit-equal to the plain version's (clip, then the cast's
    round to nearest even), in both layouts, and the amax exact, over
    values from 1e-4 to past the format's range; the amax alone."""
    from paddle_tpu_torch.kernels import fp8_matmul as tf8

    g = torch.Generator(device=dev).manual_seed(1)
    shape = (300, 520)
    mag = 10.0 ** (torch.rand(shape, device=dev, generator=g) * 8 - 4)
    sign = torch.randint(0, 2, shape, device=dev, generator=g) * 2 - 1
    x = (mag * sign).to(dtype)
    for s in (1.0, 0.37, 3.1e-3):
        scale = torch.tensor(s, device=dev)
        before = tf8.quantize_launches
        q, qt, am = tf8.quantize(x, scale, fmt, rows=True, transposed=True,
                                 amax=True)
        assert tf8.quantize_launches == before + 1
        wq, wqt, wam = tf8.quantize_reference(x, scale, fmt, True, True, True)
        assert torch.equal(q.view(torch.uint8), wq.view(torch.uint8))
        assert torch.equal(qt.view(torch.uint8), wqt.view(torch.uint8))
        assert float(am) == float(wam)
    _, _, am = tf8.quantize(x, None, fmt, rows=False, amax=True)
    assert float(am) == float(x.float().abs().max())


@pytest.mark.cuda
def test_o3_linear_on_the_card_matches_cpu(dev):
    """One fp8 linear forward and backward on the card against the CPU
    (the plain versions) from the same inputs: the codes the same, the
    products within the summation bound plus the rounding to bf16."""
    from paddle_tpu_torch.amp import fp8

    gen = np.random.RandomState(3)
    x = torch.from_numpy(gen.randn(512, 1024).astype(np.float32))
    w = torch.from_numpy((gen.randn(1024, 384) * 0.05).astype(np.float32))
    g = torch.from_numpy(gen.randn(512, 384).astype(np.float32))
    outs = {}
    for d in (dev, torch.device("cpu")):
        xd = x.to(d, torch.bfloat16).requires_grad_(True)
        wd = w.to(d, torch.bfloat16).requires_grad_(True)
        with fp8.fp8_autocast(None) as ctx:
            out = fp8.fp8_linear_value(xd, wd, None)
        out.backward(g.to(d, torch.bfloat16))
        outs[d.type] = [t.float().cpu() for t in (out, xd.grad, wd.grad)]
        outs[d.type].append({k: v.cpu() for k, v in ctx.new_state.items()})
    for got, want in zip(outs["cuda"][:3], outs["cpu"][:3]):
        # K 1024 fp32 sums in another order; both sides round to bf16
        assert _err(got, want) <= 2.0 ** -7 * float(want.abs().max())
    for k, v in outs["cpu"][3].items():
        assert torch.equal(outs["cuda"][3][k], v), k
