"""The port's kernel modules (paddle_tpu_torch.kernels) against the JAX
package's kernels.

On the CPU every wrapper runs its plain PyTorch version, so these tests
hold each plain version against the TPU kernel's function: the Pallas
kernels run in interpret mode, as the JAX package's own tests run them.
Inputs are made from a seed with numpy and handed to both sides.
Tolerances:

- fp32: 1e-6 relative (rms_norm, rope: the same fp32 ops in another
  reduction order) and 1e-5 (paged attention: sums over up to 32 slots);
- bf16 rms_norm / rope: one bf16 ulp (2^-7 relative), since the fp32
  rstd may differ in its last bit and flip one final rounding;
- bf16 paged attention: 3e-2, the bound the JAX package holds between
  its own kernel and its composed path (tests/test_kernel_autotune.py).

Backward passes, against ``jax.vjp`` of the JAX kernels:

- RMSNorm: fp32 1e-6 relative; bf16 ``dx`` one bf16 ulp; bf16 ``dw``
  2^-6 relative to the largest entry, because the fp32 sum over the rows
  runs in another order (row blocks in the Pallas kernel, one reduction
  here) before the cast, which may flip one rounding of a small entry.
- Rope: fp32 1e-6 relative, bf16 one ulp (the same rotation by -theta).
- Flash attention (``flash_attention_fwd`` through its CPU path
  ``_composed``), O, LSE and dq/dk/dv: fp32 1e-5 (scores and softmax in
  fp32, summed in another order; LSE against ``logsumexp`` of the
  composed scores). bf16 3e-2 absolute plus 3e-2 relative, the bound
  the repo already uses between kernel and composed paths: ``_composed``
  rounds the scores and P to bf16 before the value product and does its
  backward products in bf16, the port keeps the scores in fp32.
- Flash attention's plain forward and backward against jax's stock
  Pallas flash kernel itself (interpret mode): fp32 1e-5 of the largest
  entry; bf16 1e-2 of it (the stock kernel rounds the unnormalised P of
  each block, the plain version the normalised P), dV 1e-3 plus each
  entry's own cast (both round P^T at the same point).
- The bf16 tensor-core kernels' order of work, emulated, within
  cast-once plus ``probability_rounding_slack`` of the plain version;
  three seeded faults must fall outside it.
- The fp32 split design's order of work (three bf16 parts a value, six
  products a product), emulated, within the fp32 tolerances of the JAX
  package's fp32 flash path (1e-5 of the largest O and LSE entry, 1e-4
  for the gradients); three seeded faults must fall outside them.

The CUDA kernels themselves are compared with their plain versions on
the card, by tests/test_torch_cuda.py and chip_smoke.py.
"""
import math
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from paddle_tpu.kernels import flash_attention as jfa  # noqa: E402
from paddle_tpu.kernels import fused_rope_attention as jfra  # noqa: E402
from paddle_tpu.kernels import paged_attention as jpa  # noqa: E402
from paddle_tpu.kernels import rope as jrope  # noqa: E402
from paddle_tpu.kernels.rms_norm import rms_norm_fused  # noqa: E402
from paddle_tpu.kernels.rope import build_rope_cache  # noqa: E402
from paddle_tpu_torch.kernels import _build  # noqa: E402
from paddle_tpu_torch.kernels import flash_attention as tfa  # noqa: E402
from paddle_tpu_torch.kernels import fused_rope_attention as tfra  # noqa
from paddle_tpu_torch.kernels import paged_attention as tpa  # noqa: E402
from paddle_tpu_torch.kernels import rms_norm as trms  # noqa: E402
from paddle_tpu_torch.kernels import rope as trope  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread per module: the suite runs several workers at
    once, and each torch process would otherwise use every core. The
    other port test modules import it, which makes it theirs too."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BF16_ULP = 2.0 ** -7
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _both(a, dtype):
    """One float32 numpy array -> (jnp, torch) arrays in ``dtype``."""
    jd, td = DTYPES[dtype]
    a = np.asarray(a, np.float32)
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _assert_close(got, want, dtype, fp32_rtol=1e-6):
    rtol = BF16_ULP if dtype == "bfloat16" else fp32_rtol
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=1e-6)


# ------------------------------------------------------------ rms_norm
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(6, 64), (2, 3, 128)])
def test_rms_norm_plain_matches_pallas(dtype, shape):
    rng = np.random.RandomState(0)
    xj, xt = _both(rng.randn(*shape), dtype)
    wj, wt = _both(1 + 0.1 * rng.randn(shape[-1]), dtype)
    want = rms_norm_fused(xj, wj, 1e-5)
    got = trms.rms_norm(xt, wt, 1e-5)
    assert got.dtype == xt.dtype and tuple(got.shape) == shape
    _assert_close(got, want, dtype)


# ---------------------------------------------------------------- rope
def test_rope_tables_match():
    cj, sj = jrope.build_rope_cache(40, 16, base=10000.0)
    ct, st = trope.build_rope_cache(40, 16, base=10000.0)
    assert tuple(ct.shape) == (1, 40, 1, 8)
    np.testing.assert_allclose(_np(ct), _np(cj), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_np(st), _np(sj), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tables", ["shared", "per_row"])
def test_rope_plain_matches_pallas(dtype, tables):
    rng = np.random.RandomState(1)
    b, s, h, d = 2, 5, 3, 16
    xj, xt = _both(rng.randn(b, s, h, d), dtype)
    tb = 1 if tables == "shared" else b
    ang = rng.rand(tb, s, 1, d // 2).astype(np.float32) * 6.0
    cos, sin = np.cos(ang), np.sin(ang)
    want = jrope.rope_fused(xj, jnp.asarray(cos), jnp.asarray(sin))
    got, none = trope.rope_fused(xt, None, torch.from_numpy(cos),
                                 torch.from_numpy(sin))
    assert none is None and got.dtype == xt.dtype
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_position_ids_match_gathered_tables(dtype):
    """The port looks table rows up by position id (what the kernel
    does); the JAX path gathers per-row tables first and rotates with
    them. Same function, q and k together."""
    rng = np.random.RandomState(2)
    b, h, kh, d = 3, 4, 2, 16
    qj, qt = _both(rng.randn(b, 1, h, d), dtype)
    kj, kt = _both(rng.randn(b, 1, kh, d), dtype)
    cos, sin = jrope.build_rope_cache(32, d)
    ids = np.array([[0], [7], [31]], np.int32)
    cg = jnp.take(cos[0, :, 0, :], jnp.asarray(ids), axis=0)[:, :, None, :]
    sg = jnp.take(sin[0, :, 0, :], jnp.asarray(ids), axis=0)[:, :, None, :]
    want_q = jrope.rope_fused(qj, cg, sg)
    want_k = jrope.rope_fused(kj, cg, sg)
    ct, st = torch.tensor(np.asarray(cos)), torch.tensor(np.asarray(sin))
    got_q, got_k = trope.rope_fused(qt, kt, ct, st, torch.from_numpy(ids))
    _assert_close(got_q, want_q, dtype)
    _assert_close(got_k, want_k, dtype)


# ------------------------------------------------------ paged attention
# case: (query heads, kv heads, head_dim, table width in pages); row 0
# holds 2 pages (its tail points at the garbage page 0), row 1 attends up
# to slot 8 * width - 5
PAGED_CASES = {
    "mha": (4, 4, 16, 4),
    "gqa": (4, 2, 16, 4),
    "d80": (4, 2, 80, 4),
    "d96": (4, 4, 96, 4),
    "mqa_g16": (16, 1, 16, 4),
    "long": (2, 1, 16, 72),   # a row of more than 64 pages
    # a head dim that is not a multiple of 16 (the card stages its rows
    # in smaller pieces and zero-fills them to the next multiple)
    "d72": (4, 2, 72, 4),
}


def _paged_inputs(dtype, kvh, h=4, d=16, pages=4):
    rng = np.random.RandomState(5)
    b, ps = 2, 8
    n = b * pages + 1
    q = rng.randn(b, 1, h, d)
    kp = rng.randn(n, ps, kvh, d)
    vp = rng.randn(n, ps, kvh, d)
    tbl = (1 + np.arange(b * pages).reshape(b, pages)).astype(np.int32)
    tbl[0, 2:] = 0  # row 0 holds 2 pages; its tail points at page 0
    pos = np.array([13, 8 * pages - 5], np.int32)
    j = [_both(a, dtype)[0] for a in (q, kp, vp)]
    t = [_both(a, dtype)[1] for a in (q, kp, vp)]
    j += [jnp.asarray(tbl), jnp.asarray(pos)]
    t += [torch.from_numpy(tbl), torch.from_numpy(pos)]
    return j, t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(PAGED_CASES))
@pytest.mark.parametrize("ref", ["fused", "reference", "composed"])
def test_paged_attention_plain_matches_jax(dtype, case, ref):
    """MHA, GQA, head dims 80 and 96, MQA with 16 query heads per kv
    head, and a row of 72 pages, against the TPU kernel (interpret mode)
    and the JAX package's two plain paths."""
    h, kvh, d, pages = PAGED_CASES[case]
    (qj, kj, vj, tj, pj), (qt, kt, vt, tt, pt) = _paged_inputs(
        dtype, kvh, h, d, pages)
    fn = {"fused": jpa.paged_attention_fused,
          "reference": jpa.paged_attention_reference,
          "composed": jpa.paged_attention_composed}[ref]
    # one compiled program a case (op-by-op dispatch compiles every
    # primitive at each new shape, several times slower on the CPU)
    want = jax.jit(fn)(qj, kj, vj, tj, pj)
    got = tpa.paged_attention(qt, kt, vt, tt, pt)
    assert got.dtype == qt.dtype and tuple(got.shape) == tuple(qt.shape)
    tol = 3e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


# ------------------------------- the paged kernels' order of work
PAGED_TOL = {"float32": 1e-5, "bfloat16": 1e-2}  # chip_smoke.py's


def _emulate_paged_kernels(q, k_pages, v_pages, table, pos, chunk,
                           fault=None):
    """The two paged kernels' order of work in plain PyTorch: each row's
    live slots cut into chunks of ``chunk``; per chunk the fp32 scores,
    their max m_c and sum of exp(s - m_c) (kernel 1); the row's m and l
    combined from the chunks' statistics (lane k of a warp takes chunks
    k, k + 32, ... in order, then a butterfly over the 32 lanes), p =
    exp(s - m) / l rounded to q's dtype, the fp32 partial P V of each
    chunk, and the partials summed in chunk order (kernel 2).
    ``fault``: "skip_chunk" (chunk 1's partial is lost), "neighbour_max"
    (a chunk's sum is rescaled with the next chunk's max),
    "pos_off_by_one" (a row attends slot pos + 1 too)."""
    b, _, h, d = (int(v) for v in q.shape)
    kvh = int((k_pages.q if hasattr(k_pages, "q") else k_pages).shape[2])
    g = h // kvh
    scale = 1.0 / math.sqrt(d)
    kk = tpa.gather_pages_fp32(k_pages, table)       # [B, S, kvH, D]
    vv = tpa.gather_pages_fp32(v_pages, table)
    s_virt = int(kk.shape[1])
    out = torch.empty(b, 1, h, d, dtype=q.dtype)
    for r in range(b):
        n = min(int(pos[r]) + (2 if fault == "pos_off_by_one" else 1),
                s_virt)
        bounds = [(c0, min(c0 + chunk, n)) for c0 in range(0, n, chunk)]
        for kh in range(kvh):
            qg = q[r, 0, kh * g:(kh + 1) * g].float()          # [G, D]
            sc = (qg @ kk[r, :n, kh].T) * scale                # [G, n]
            stats = []
            for c0, c1 in bounds:
                m_c = sc[:, c0:c1].amax(-1)
                stats.append((m_c, torch.exp(sc[:, c0:c1]
                                             - m_c[:, None]).sum(-1)))
            m = torch.stack([st[0] for st in stats]).amax(0)
            lanes = torch.zeros(32, g)
            for c, (m_c, l_c) in enumerate(stats):
                if fault == "neighbour_max":
                    m_c = stats[min(c + 1, len(stats) - 1)][0]
                lanes[c % 32] = lanes[c % 32] + l_c * torch.exp(m_c - m)
            for o in (16, 8, 4, 2, 1):
                lanes = lanes + lanes[torch.arange(32) ^ o]
            l = lanes[0]
            p = (torch.exp(sc - m[:, None]) / l[:, None]).to(q.dtype).float()
            acc = torch.zeros(g, d)
            for c, (c0, c1) in enumerate(bounds):
                if fault == "skip_chunk" and c == 1:
                    continue
                acc = acc + p[:, c0:c1] @ vv[r, c0:c1, kh]
            out[r, 0, kh * g:(kh + 1) * g] = acc.to(q.dtype)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arena", ["float", "int8"])
@pytest.mark.parametrize("fault", [None, "skip_chunk", "neighbour_max",
                                   "pos_off_by_one"])
def test_paged_kernels_order_of_work_within_tolerance(dtype, arena, fault):
    """The emulated paged kernels (chunks of one 8-slot page: rows of 1,
    6 and 12 chunks; the kernels take any chunk size) lie within
    chip_smoke.py's ``PAGED_TOL`` of ``paged_attention_reference``; each
    seeded fault falls outside it, so the tolerance does not hide a wrong
    kernel."""
    from paddle_tpu_torch.quantization.kv import QuantizedKV, quantize_kv

    rng = np.random.RandomState(21)
    b, h, kvh, d, ps, width = 3, 8, 2, 80, 8, 12
    td = DTYPES[dtype][1]
    q = torch.from_numpy(rng.randn(b, 1, h, d).astype(np.float32)).to(td)
    kp, vp = (torch.from_numpy(rng.randn(b * width + 1, ps, kvh, d)
                               .astype(np.float32)) for _ in range(2))
    if arena == "int8":
        kp, vp = (QuantizedKV(*quantize_kv(t)) for t in (kp, vp))
    else:
        kp, vp = kp.to(td), vp.to(td)
    tbl = torch.from_numpy(
        (1 + np.arange(b * width).reshape(b, width)).astype(np.int32))
    pos = torch.tensor([3, 40, 90], dtype=torch.int32)
    tbl[0, 1:] = 0  # row 0 holds one page; its tail is the garbage page
    tbl[1, 6:] = 0
    got = _emulate_paged_kernels(q, kp, vp, tbl, pos, ps, fault)
    want = tpa.paged_attention_reference(q, kp, vp, tbl, pos)
    ratio = float((got.float() - want.float()).abs().max()) / PAGED_TOL[dtype]
    print(f"paged kernels emulation {arena} {dtype} fault={fault}: error "
          f"over tolerance {ratio:.4g}")
    if fault is None:
        assert ratio <= 1.0
    else:
        assert ratio > 1.0


@pytest.mark.parametrize("shape", [(16, 128, 2, 1), (16, 128, 1, 1),
                                   (16, 128, 2, 32), (16, 16, 2, 1),
                                   (8, 80, 2, 4), (256, 256, 4, 1)])
def test_paged_chunk_slots(shape):
    """A chunk is a whole number of pages (or, a page larger than the
    chunk's budget, a power of two dividing it), its K or V rows fit the
    shared-memory budget, and a group of G query heads gets at most
    CHUNK_WORK / G slots."""
    ps, d, itemsize, group = shape
    c = tpa.chunk_slots(ps, d, itemsize, group)
    assert c >= 1 and (c % ps == 0 if c >= ps else ps % c == 0)
    assert c <= tpa.MAX_CHUNK and c * d * itemsize <= max(
        tpa.CHUNK_BYTES, ps * d * itemsize)
    assert c <= max(tpa.CHUNK_WORK // group, min(ps, 16))


def test_gather_pages_matches():
    (_, kj, _, tj, _), (_, kt, _, tt, _) = _paged_inputs("float32", 2)
    np.testing.assert_array_equal(_np(tpa.gather_pages(kt, tt)),
                                  _np(jpa.gather_pages(kj, tj)))


def test_paged_attention_ignores_garbage_page():
    """Slots past ``pos`` (here: the whole garbage page 0 and the unused
    tail) cannot change the result."""
    _, (q, kp, vp, tbl, pos) = _paged_inputs("float32", 2)
    base = tpa.paged_attention(q, kp, vp, tbl, pos)
    kp2, vp2 = kp.clone(), vp.clone()
    kp2[0] = 1e4
    vp2[0] = -1e4
    kp2[tbl[1, 3], 4:] = 7.0  # row 1 attends slots <= 27 of page 4's 0..3
    np.testing.assert_array_equal(
        tpa.paged_attention(q, kp2, vp2, tbl, pos).numpy(), base.numpy())


def _closer(got, want, rtol, atol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


# ------------------------------------------------------ RMSNorm backward
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(6, 64), (2, 5, 128)])
def test_rms_norm_backward_matches_pallas_vjp(dtype, shape):
    rng = np.random.RandomState(10)
    xj, xt = _both(rng.randn(*shape), dtype)
    wj, wt = _both(1 + 0.1 * rng.randn(shape[-1]), dtype)
    gj, gt = _both(rng.randn(*shape), dtype)
    _, vjp = jax.vjp(lambda x, w: rms_norm_fused(x, w, 1e-5), xj, wj)
    want_dx, want_dw = vjp(gj)
    # through the autograd Function (the plain forward keeps rstd)
    xg = xt.clone().requires_grad_(True)
    wg = wt.clone().requires_grad_(True)
    trms.rms_norm(xg, wg, 1e-5).backward(gt)
    _, rstd = trms.rms_norm_reference(xt, wt, 1e-5, return_rstd=True)
    dx, dw = trms.rms_norm_backward_reference(xt, wt, gt, rstd)
    assert torch.equal(xg.grad, dx) and torch.equal(wg.grad, dw)
    assert dx.dtype == xt.dtype and dw.dtype == wt.dtype
    if dtype == "float32":
        _closer(dx, want_dx, 1e-6, 1e-6)
        _closer(dw, want_dw, 1e-6, 1e-6)
    else:
        _closer(dx, want_dx, BF16_ULP, 1e-6)
        np.testing.assert_allclose(
            _np(dw), _np(want_dw), rtol=0,
            atol=2.0 ** -6 * float(np.abs(_np(want_dw)).max()))


# --------------------------------------------------------- rope backward
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_backward_matches_pallas_vjp(dtype):
    rng = np.random.RandomState(11)
    b, s, h, kh, d = 2, 6, 4, 2, 16
    qj, qt = _both(rng.randn(b, s, h, d), dtype)
    kj, kt = _both(rng.randn(b, s, kh, d), dtype)
    gqj, gqt = _both(rng.randn(b, s, h, d), dtype)
    gkj, gkt = _both(rng.randn(b, s, kh, d), dtype)
    cj, sj = jrope.build_rope_cache(s, d)
    ct, st = trope.build_rope_cache(s, d)
    _, vq = jax.vjp(lambda x: jrope.rope_fused(x, cj, sj), qj)
    _, vk = jax.vjp(lambda x: jrope.rope_fused(x, cj, sj), kj)
    qg = qt.clone().requires_grad_(True)
    kg = kt.clone().requires_grad_(True)
    qo, ko = trope.rope_fused(qg, kg, ct, st)
    torch.autograd.backward([qo, ko], [gqt, gkt])
    rtol = BF16_ULP if dtype == "bfloat16" else 1e-6
    _closer(qg.grad, vq(gqj)[0], rtol, 1e-6)
    _closer(kg.grad, vk(gkj)[0], rtol, 1e-6)
    assert torch.equal(qg.grad, trope.rope_backward_reference(gqt, ct, st))


# ------------------------------------------------------- flash attention
FLASH_CASES = {
    # causal, sq, sk, head_dim (80 and 96: public models' widths, which
    # the card runs on the 128-wide kernels with the columns past D masked)
    "causal": (True, 8, 8, 16),
    "causal_sq_lt_sk": (True, 5, 9, 16),
    "full": (False, 6, 9, 16),
    "causal_d80": (True, 8, 8, 80),
    "causal_sq_lt_sk_d96": (True, 5, 9, 96),
    "full_d80": (False, 6, 9, 80),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention_matches_jax(dtype, case):
    causal, sq, sk, d = FLASH_CASES[case]
    rng = np.random.RandomState(12)
    b, h = 2, 3
    qn, kn, vn = (rng.randn(b, n, h, d) for n in (sq, sk, sk))
    gn = rng.randn(b, sq, h, d)
    (qj, qt), (kj, kt), (vj, vt), (gj, gt) = (
        _both(a, dtype) for a in (qn, kn, vn, gn))
    scale = 1.0 / np.sqrt(d)

    @jax.jit  # one compiled program a case (see the paged test)
    def forward_and_vjp(q, k, v, g):
        o, vjp = jax.vjp(
            lambda q, k, v: jfa.flash_attention_fwd(q, k, v, causal=causal,
                                                    scale=scale), q, k, v)
        return o, vjp(g)

    want_o, want = forward_and_vjp(qj, kj, vj, gj)
    ts = [t.clone().requires_grad_(True) for t in (qt, kt, vt)]
    o, lse = tfa.flash_attention(*ts, causal=causal, return_lse=True)
    o.backward(gt)
    assert o.dtype == qt.dtype and lse.dtype == torch.float32
    assert tuple(lse.shape) == (b, h, sq)
    # LSE against logsumexp of the composed fp32 scores
    qf, kf = (_np(t) for t in (qt, kt))
    s = np.einsum("bqhd,bkhd->bhqk", qf, kf).astype(np.float64) * scale
    if causal:
        s = np.where(np.tril(np.ones((sq, sk), bool), sk - sq), s, -np.inf)
    mx = s.max(-1, keepdims=True)
    want_lse = (mx + np.log(np.exp(s - mx).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(_np(lse), want_lse, rtol=1e-5, atol=1e-5)
    tol = 3e-2 if dtype == "bfloat16" else 1e-5
    _closer(o, want_o, tol, tol)
    for got, w in zip(ts, want):
        _closer(got.grad, w, tol, tol)
    # the plain backward is what the Function ran
    dq, dk, dv = tfa.flash_attention_backward_reference(
        qt, kt, vt, o.detach(), lse, gt, causal)
    assert torch.equal(ts[0].grad, dq) and torch.equal(ts[2].grad, dv)


# ------------------------------- head dims that are not multiples of 16
# The card runs them zero-padded to the next multiple of 16 through
# ``padded_forward`` / ``padded_backward`` / ``padded_rope_attention``;
# here those helpers wrap the plain versions. 72 and 40 (both 8 mod 16).
ODD_HEAD_DIMS = (72, 40)


class _Width:
    """Wraps a kernel-shaped function, recording the head dims it saw."""

    def __init__(self, fn):
        self.fn, self.widths = fn, set()

    def __call__(self, *args):
        self.widths.add(int(args[0].shape[-1]))
        return self.fn(*args)


@pytest.mark.parametrize("d", ODD_HEAD_DIMS)
def test_padded_flash_equals_unpadded_and_jax(d):
    """fp32 forward and backward through the pad-and-slice helpers equal
    the unpadded plain versions, and JAX's flash attention and its VJP
    (the scale stays 1/sqrt of the true head dim)."""
    rng = np.random.RandomState(d)
    b, sq, sk, h = 2, 7, 9, 3
    (qj, qt), (kj, kt), (vj, vt), (gj, gt) = (
        _both(rng.randn(b, n, h, d), "float32") for n in (sq, sk, sk, sq))
    scale = 1.0 / np.sqrt(d)
    fwd = _Width(tfa.flash_attention_reference)
    o, lse = tfa.padded_forward(fwd, qt, kt, vt, True, scale)
    assert fwd.widths == {tfa.padded_head_dim(d)} and o.shape == qt.shape
    ro, rlse = tfa.flash_attention_reference(qt, kt, vt, True, scale)
    _closer(o, ro, 1e-6, 1e-6)
    _closer(lse, rlse, 1e-6, 1e-6)
    bwd = _Width(tfa.flash_attention_backward_reference)
    grads = tfa.padded_backward(bwd, qt, kt, vt, o, lse, gt, True, scale)
    assert bwd.widths == {tfa.padded_head_dim(d)}
    want = tfa.flash_attention_backward_reference(qt, kt, vt, o, lse, gt,
                                                  True, scale)
    for got, w in zip(grads, want):
        assert got.shape == w.shape
        _closer(got, w, 1e-6, 1e-6)
    want_o, vjp = jax.vjp(
        lambda q, k, v: jfa.flash_attention_fwd(q, k, v, causal=True,
                                                scale=scale), qj, kj, vj)
    _closer(o, want_o, 1e-5, 1e-5)
    for got, w in zip(grads, vjp(gj)):
        _closer(got, w, 1e-5, 1e-5)


@pytest.mark.parametrize("d", ODD_HEAD_DIMS)
def test_padded_rope_attention_equals_unpadded_and_jax(d):
    """The rope-on-load padding, half by half (column c still pairs with
    c + d/2 of the true d), equals the unpadded plain version and the JAX
    kernel (interpret mode), fp32."""
    rng = np.random.RandomState(d + 1)
    b, s, h = 2, 32, 2
    (qj, qt), (kj, kt), (vj, vt) = (_both(rng.randn(b, s, h, d), "float32")
                                    for _ in range(3))
    cos, sin = build_rope_cache(s, d)
    tcos, tsin = (torch.tensor(np.asarray(t))[0, :, 0] for t in (cos, sin))
    fn = _Width(tfra._composed)
    got = tfra.padded_rope_attention(fn, qt, kt, vt, tcos, tsin, True,
                                     1.0 / np.sqrt(d))
    assert fn.widths == {tfa.padded_head_dim(d)} and got.shape == qt.shape
    _closer(got, tfra.rope_attention_reference(qt, kt, vt, tcos, tsin),
            1e-6, 1e-6)
    want = jfra.rope_attention_fused(qj, kj, vj, cos, sin, causal=True,
                                     block_q=16)
    _closer(got, want, 1e-5, 1e-5)
    # the unfused rope kernel's padding (each half to a whole number of
    # 16-byte bf16 vectors): the same rotation
    hp = -(-d // 2 // 8) * 8
    padded = [torch.nn.functional.pad(torch.tensor(np.asarray(t)),
                                      (0, hp - d // 2)) for t in (cos, sin)]
    rot = trope.unpad_halves(trope.rope_reference(
        trope.pad_halves(qt, hp), *padded), d // 2)
    assert torch.equal(rot, trope.rope_reference(
        qt, *(torch.tensor(np.asarray(t)) for t in (cos, sin))))


# ------------------------------------- flash against the stock TPU kernel
def _stock_flash(qn, kn, vn, gn, dtype, causal):
    """jax's stock Pallas flash attention (the kernel the JAX package
    reaches on a TPU), forward and ``jax.vjp``, in TPU interpret mode with
    every block 128 and 32-bit indices (the kernel's own; the suite turns
    x64 on); [B, S, H, D] numpy in, [B, S, H, D] numpy out."""
    from jax.experimental.pallas import tpu as pltpu
    from jax.experimental.pallas.ops.tpu import flash_attention as stock

    blocks = stock.BlockSizes(
        block_q=128, block_k_major=128, block_k=128, block_b=1,
        block_q_major_dkv=128, block_k_major_dkv=128, block_k_dkv=128,
        block_q_dkv=128, block_k_major_dq=128, block_k_dq=128,
        block_q_dq=128)
    q, k, v, g = (_both(a, dtype)[0].transpose(0, 2, 1, 3)
                  for a in (qn, kn, vn, gn))
    scale = 1.0 / np.sqrt(qn.shape[-1])
    @jax.jit  # one compiled program (op-by-op is several times slower)
    def forward_and_vjp(q, k, v, g):
        o, vjp = jax.vjp(lambda q, k, v: stock.flash_attention(
            q, k, v, causal=causal, sm_scale=scale, block_sizes=blocks),
            q, k, v)
        return o, vjp(g)

    with pltpu.force_tpu_interpret_mode(), jax.enable_x64(False):
        o, grads = forward_and_vjp(q, k, v, g)
    return [_np(x).transpose(0, 2, 1, 3) for x in (o, *grads)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_plain_matches_stock_pallas_kernel(dtype, causal):
    """The plain forward and backward (what the CUDA kernels are held to)
    against the stock TPU kernel itself. bf16: O, dQ, dK, dV within 1e-2
    of the largest entry (the stock kernel rounds the unnormalised P of
    each block, the plain version the normalised P), dV within 1e-3 of
    the largest entry plus the cast of each entry to bf16 (2^-7 of it:
    both round P^T at the same point from fp32 values that agree, and
    the two fp32 results may still round one ulp apart); fp32 1e-5 of
    the largest entry (the same arithmetic summed in another order)."""
    rng = np.random.RandomState(12)
    b, s, h, d = 1, 256, 2, 128
    qn, kn, vn, gn = (rng.randn(b, s, h, d).astype(np.float32)
                      for _ in range(4))
    want = _stock_flash(qn, kn, vn, gn, dtype, causal)
    q, k, v, g = (_both(a, dtype)[1] for a in (qn, kn, vn, gn))
    o, lse = tfa.flash_attention_reference(q, k, v, causal)
    got = [o, *tfa.flash_attention_backward_reference(q, k, v, o, lse, g,
                                                      causal)]
    tol = 1e-2 if dtype == "bfloat16" else 1e-5
    for name, x, w in zip(("o", "dq", "dk", "dv"), got, want):
        top = np.abs(w).max()
        err = np.abs(_np(x) - w)
        assert err.max() <= tol * top, (name, err.max() / top)
        if dtype == "bfloat16" and name == "dv":
            assert (err <= 1e-3 * top + BF16_ULP * np.abs(w)).all(), name


# ------------------------------------------- the bf16 rounding slack
def _round_bits(x, bits):
    """x rounded to ``bits`` explicit mantissa bits (bf16 has 7)."""
    m, e = torch.frexp(x)
    return torch.ldexp(torch.round(m * 2.0 ** (bits + 1)) / 2.0 ** (bits + 1),
                       e)


def _emulate_tc_flash(q, k, v, g, causal, fault=None):
    """The tensor-core kernels' order of work in plain PyTorch (fp32 sums
    of bf16 operands): the forward over q tiles of 64 rows and k tiles of
    128 with a running max, P = exp2(S - m) rounded to bf16 unnormalised
    tile by tile, l summed from the unrounded P; the dK/dV pass over k
    tiles of 64 and q blocks of 64 with P^T and dS^T (scaled) rounded per
    tile; the dQ pass over q tiles of 64 and k blocks of 64 with dS
    rounded per tile. ``fault``: "skip_tile" (the forward skips its second
    k tile), "diagonal" (the causal mask lets each row see one more key),
    "p_bits" (P rounded to 4 mantissa bits). Returns (o, lse, dq, dk,
    dv) in the plain version's layouts and dtypes."""
    dt = q.dtype
    qf, kf, vf, gf = (t.float().transpose(1, 2) for t in (q, k, v, g))
    sq, sk, d = qf.shape[2], kf.shape[2], qf.shape[3]
    scale = 1.0 / math.sqrt(d)
    sl2 = scale * math.log2(math.e)
    shift = sk - sq + (1 if fault == "diagonal" else 0)

    def rnd(p):
        p = _round_bits(p, 4) if fault == "p_bits" else p
        return p.to(dt).float()

    def visible(r0, rows, c0, cols):
        r = torch.arange(r0, r0 + rows)[:, None]
        c = torch.arange(c0, c0 + cols)[None, :]
        keep = c < sk
        return keep & (c <= r + shift) if causal else keep

    o = torch.zeros_like(qf)
    lse = torch.zeros(qf.shape[:3])
    for q0 in range(0, sq, 64):
        qt = qf[:, :, q0:q0 + 64]
        rows = qt.shape[2]
        m = torch.full(qt.shape[:3] + (1,), -math.inf)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qt)
        for t, k0 in enumerate(range(0, sk, 128)):
            if fault == "skip_tile" and t == 1:
                continue
            if causal and k0 > q0 + rows - 1 + shift:
                break
            s = qt @ kf[:, :, k0:k0 + 128].transpose(-1, -2) * sl2
            s = s.masked_fill(~visible(q0, rows, k0, s.shape[-1]), -math.inf)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + rnd(p) @ vf[:, :, k0:k0 + 128]
            m = m_new
        o[:, :, q0:q0 + 64] = acc / l
        lse[:, :, q0:q0 + 64] = (m * math.log(2) + torch.log(l))[..., 0]
    o = o.to(dt)
    delta = (gf * o.float()).sum(-1)
    lse2 = lse * math.log2(math.e)

    def p_ds(q0, rows, k0, cols):
        s = qf[:, :, q0:q0 + rows] @ kf[:, :, k0:k0 + cols].transpose(-1, -2)
        p = torch.exp2(s * sl2 - lse2[:, :, q0:q0 + rows, None])
        p = p * visible(q0, rows, k0, cols)
        dp = gf[:, :, q0:q0 + rows] @ vf[:, :, k0:k0 + cols].transpose(-1, -2)
        return p, p * (dp - delta[:, :, q0:q0 + rows, None]) * scale

    dq, dk, dv = (torch.zeros_like(t) for t in (qf, kf, vf))
    for k0 in range(0, sk, 64):
        cols = min(64, sk - k0)
        for q0 in range(0, sq, 64):
            rows = min(64, sq - q0)
            p, ds = p_ds(q0, rows, k0, cols)
            dv[:, :, k0:k0 + cols] += rnd(p).transpose(-1, -2) \
                @ gf[:, :, q0:q0 + rows]
            dk[:, :, k0:k0 + cols] += ds.to(dt).float().transpose(-1, -2) \
                @ qf[:, :, q0:q0 + rows]
    for q0 in range(0, sq, 64):
        rows = min(64, sq - q0)
        for k0 in range(0, sk, 64):
            _, ds = p_ds(q0, rows, k0, min(64, sk - k0))
            dq[:, :, q0:q0 + rows] += ds.to(dt).float() \
                @ kf[:, :, k0:k0 + 64]
    back = [t.transpose(1, 2).to(dt) for t in (o.float(), dq, dk, dv)]
    return back[0], lse, back[1], back[2], back[3]


def _within_slack(got, q, k, v, g, causal):
    """Largest error over tolerance of (o, dq, dk, dv) against the plain
    version fed the same O and LSE: per entry 2^-7 |plain| + (1e-5 for O,
    1e-4 for the gradients) * max |plain| + the rounding slack."""
    o, lse, *grads = got
    want = [tfa.flash_attention_reference(q, k, v, causal)[0],
            *tfa.flash_attention_backward_reference(q, k, v, o, lse, g,
                                                    causal)]
    o_slack, slacks = tfa.probability_rounding_slack(q, k, v, lse, o, g,
                                                     causal)
    worst = 0.0
    for x, w, tol32, sl in zip((o, *grads), want, (1e-5, 1e-4, 1e-4, 1e-4),
                               (o_slack, *slacks)):
        w = w.float()
        tol = BF16_ULP * w.abs() + tol32 * float(w.abs().max()) + sl
        worst = max(worst, float(((x.float() - w).abs() / tol).max()))
    return worst


@pytest.mark.parametrize("fault", [None, "skip_tile", "diagonal", "p_bits"])
def test_flash_rounding_slack_holds_emulated_kernel(fault):
    """The bf16 tensor-core kernels' order of work (emulated) lies within
    cast-once plus ``probability_rounding_slack`` of the plain version;
    three seeded faults each fall outside it, so the slack does not hide
    a wrong kernel."""
    rng = np.random.RandomState(5)
    b, s, h, d = 1, 200, 2, 64
    q, k, v, g = (torch.from_numpy(rng.randn(b, s, h, d).astype(np.float32))
                  .to(torch.bfloat16) for _ in range(4))
    ratio = _within_slack(_emulate_tc_flash(q, k, v, g, True, fault),
                          q, k, v, g, True)
    if fault is None:
        assert ratio <= 1.0
    else:
        assert ratio > 1.0


# ------------------------------------ the fp32 split design, emulated
# the terms of a product of two three-part operands, smallest first
# (hi.lo, mid.mid, lo.hi, hi.mid, mid.hi, hi.hi), as the kernels issue
# them
SPLIT_TERMS = ((0, 2), (1, 1), (2, 0), (0, 1), (1, 0), (0, 0))


def _parts(x, n=3):
    """fp32 ``x`` as ``n`` bf16 values (held in fp32): hi = bf16(x), mid =
    bf16(x - hi), lo = bf16(x - hi - mid); each difference is exact."""
    out = []
    for _ in range(n):
        p = x.to(torch.bfloat16).float()
        out.append(p)
        x = x - p
    return out


def _split_mm(a, b, acc=None, fault=None, p_operand=False):
    """``acc + a @ b`` as the split design forms it: both operands in
    three bf16 parts, the six terms in the kernels' order, each over
    k-steps of 16 added to one fp32 accumulator. ``fault``: "two_part"
    (hi and lo parts, three terms), "no_hm" (the hi.mid term dropped),
    "no_mm" (the mid.mid term dropped), "p_bf16" (a P or P^T operand,
    ``p_operand``, taken as its hi part alone: rounded to bf16), "p_lo"
    (its lo part skipped)."""
    if fault == "two_part":
        pa, pb, terms = _parts(a, 2), _parts(b, 2), ((0, 1), (1, 0), (0, 0))
    else:
        pa, pb, terms = _parts(a), _parts(b), SPLIT_TERMS
        drop = {"no_hm": (0, 1), "no_mm": (1, 1)}.get(fault)
        terms = tuple(t for t in terms if t != drop)
        if p_operand and fault in ("p_bf16", "p_lo"):
            terms = tuple(t for t in terms
                          if t[0] == 0 or (fault == "p_lo" and t[0] == 1))
    if acc is None:
        acc = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for i, j in terms:
        for k0 in range(0, a.shape[-1], 16):
            acc = acc + pa[i][..., k0:k0 + 16] @ pb[j][..., k0:k0 + 16, :]
    return acc


def _emulate_split_flash(q, k, v, g, causal, fault=None):
    """The fp32 split design's order of work (D 64: every warpgroup owns
    64 rows of all columns) in plain PyTorch: the forward over q tiles of
    64 rows and k blocks of 64 (S from six products, the online softmax in
    the log2 domain, P split, O += P V from six products), Delta, the
    dK/dV pass over k tiles of 64 and q blocks of 64 (S^T, dP^T, P^T, dS^T
    = P^T (dP^T - Delta) scale, dV += P^T dO, dK += dS^T Q), the dQ pass
    over q tiles of 64 and k blocks of 64. Above D 128 (the pair of CTAs,
    each holding 128 columns) a product over D is the sum of the two
    CTAs' partials over their chunks of D, the first chunk's plus the
    second's (``fault`` "drop_chunk": the second one lost); the products
    over keys or rows only split their output columns. Returns (o, lse,
    dq, dk, dv) in the plain version's layouts."""
    qf, kf, vf, gf = (t.float().transpose(1, 2) for t in (q, k, v, g))
    sq, sk, d = qf.shape[2], kf.shape[2], qf.shape[3]
    scale = 1.0 / math.sqrt(d)
    sl2 = scale * math.log2(math.e)

    def mm(a, b, acc=None, p_operand=False):
        return _split_mm(a, b, acc, fault, p_operand)

    def mm_d(a, b):
        """``a @ b`` over the head dim: one partial a CTA's chunk"""
        if d <= 128:
            return mm(a, b)
        parts = [mm(a[..., c:c + 128], b[..., c:c + 128, :])
                 for c in range(0, d, 128)]
        if fault == "drop_chunk":
            parts = parts[:1]
        out = parts[0]
        for part in parts[1:]:
            out = out + part
        return out

    def visible(r0, rows, c0, cols):
        r = torch.arange(r0, r0 + rows)[:, None]
        c = torch.arange(c0, c0 + cols)[None, :]
        return c <= r + (sk - sq) if causal else torch.ones(rows, cols,
                                                            dtype=bool)

    o = torch.zeros_like(qf)
    lse = torch.zeros(qf.shape[:3])
    for q0 in range(0, sq, 64):
        qt = qf[:, :, q0:q0 + 64]
        rows = qt.shape[2]
        m = torch.full(qt.shape[:3] + (1,), -math.inf)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qt)
        for k0 in range(0, sk, 64):
            if causal and k0 > q0 + rows - 1 + sk - sq:
                break
            kt, vt = kf[:, :, k0:k0 + 64], vf[:, :, k0:k0 + 64]
            s = mm_d(qt, kt.transpose(-1, -2)) * sl2
            s = s.masked_fill(~visible(q0, rows, k0, s.shape[-1]), -math.inf)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = mm(p, vt, acc * alpha, p_operand=True)
            m = m_new
        o[:, :, q0:q0 + 64] = acc / l
        lse[:, :, q0:q0 + 64] = (m * math.log(2) + torch.log(l))[..., 0]
    delta = (gf * o).sum(-1)
    lse2 = lse * math.log2(math.e)

    def p_ds(s, dp, q0, rows, k0, cols):
        p = torch.exp2(s * sl2 - lse2[:, :, q0:q0 + rows, None])
        p = p * visible(q0, rows, k0, cols)
        return p, p * (dp - delta[:, :, q0:q0 + rows, None]) * scale

    dq, dk, dv = (torch.zeros_like(t) for t in (qf, kf, vf))
    for k0 in range(0, sk, 64):
        kt, vt = kf[:, :, k0:k0 + 64], vf[:, :, k0:k0 + 64]
        cols = kt.shape[2]
        for q0 in range(0, sq, 64):
            qt, gt = qf[:, :, q0:q0 + 64], gf[:, :, q0:q0 + 64]
            rows = qt.shape[2]
            st = mm_d(kt, qt.transpose(-1, -2))
            dpt = mm_d(vt, gt.transpose(-1, -2))
            p, ds = p_ds(st.transpose(-1, -2), dpt.transpose(-1, -2), q0,
                         rows, k0, cols)
            dv[:, :, k0:k0 + cols] = mm(p.transpose(-1, -2), gt,
                                        dv[:, :, k0:k0 + cols],
                                        p_operand=True)
            dk[:, :, k0:k0 + cols] = mm(ds.transpose(-1, -2), qt,
                                        dk[:, :, k0:k0 + cols])
    for q0 in range(0, sq, 64):
        qt, gt = qf[:, :, q0:q0 + 64], gf[:, :, q0:q0 + 64]
        rows = qt.shape[2]
        for k0 in range(0, sk, 64):
            kt, vt = kf[:, :, k0:k0 + 64], vf[:, :, k0:k0 + 64]
            _, ds = p_ds(mm_d(qt, kt.transpose(-1, -2)),
                         mm_d(gt, vt.transpose(-1, -2)), q0, rows, k0,
                         kt.shape[2])
            dq[:, :, q0:q0 + rows] = mm(ds, kt, dq[:, :, q0:q0 + rows])
    back = [t.transpose(1, 2) for t in (o, dq, dk, dv)]
    return back[0], lse, back[1], back[2], back[3]


def _jax_flash_fp32(qn, kn, vn, gn, causal):
    """The JAX package's fp32 flash path on the CPU (its forward and
    ``jax.vjp``), and the float64 logsumexp of the scores: (o, lse, dq,
    dk, dv) as numpy."""
    (qj, _), (kj, _), (vj, _), (gj, _) = (_both(a, "float32")
                                          for a in (qn, kn, vn, gn))
    sq, sk, d = qn.shape[1], kn.shape[1], qn.shape[-1]
    scale = 1.0 / np.sqrt(d)
    o, vjp = jax.vjp(lambda q, k, v: jfa.flash_attention_fwd(
        q, k, v, causal=causal, scale=scale), qj, kj, vj)
    s = np.einsum("bqhd,bkhd->bhqk", qn.astype(np.float64),
                  kn.astype(np.float64)) * scale
    if causal:
        s = np.where(np.tril(np.ones((sq, sk), bool), sk - sq), s, -np.inf)
    mx = s.max(-1, keepdims=True)
    lse = (mx + np.log(np.exp(s - mx).sum(-1, keepdims=True)))[..., 0]
    return [_np(o), lse, *(_np(x) for x in vjp(gj))]


def _split_flash_ratio(fault, d=64):
    """The largest error over tolerance of the emulated fp32 split design
    (with ``fault``, at head dim ``d``) against the JAX package's fp32
    flash path: O and LSE within 1e-5 of the largest entry, dQ, dK, dV
    within 1e-4 (the fp32 tolerances, no slack). q and k have a standard
    deviation of 4, which sharpens the softmax as trained attention does
    and lets an error in the scores show in O."""
    rng = np.random.RandomState(7)
    b, s, h = 1, 160, 2
    qn, kn = (4.0 * rng.randn(b, s, h, d).astype(np.float32)
              for _ in range(2))
    vn, gn = (rng.randn(b, s, h, d).astype(np.float32) for _ in range(2))
    want = _jax_flash_fp32(qn, kn, vn, gn, True)
    got = _emulate_split_flash(*(torch.from_numpy(a) for a in
                                 (qn, kn, vn, gn)), True, fault)
    worst = 0.0
    for x, w, tol in zip(got, want, (1e-5, 1e-5, 1e-4, 1e-4, 1e-4)):
        err = np.abs(_np(x).astype(np.float64) - w).max()
        worst = max(worst, err / (tol * np.abs(w).max()))
    return worst


@pytest.mark.parametrize("fault", [None, "two_part", "no_hm", "p_bf16"])
def test_fp32_split_design_within_fp32_tolerance(fault):
    """The fp32 split design's order of work (emulated: three-part
    splits, six products in k-steps of 16, the kernels' tiles and online
    softmax, both backward passes) lies within the fp32 tolerances of the
    JAX package's fp32 flash path; three seeded faults each fall outside:
    the two-part split (about 16 bits a value), the hi.mid term dropped,
    and P taken as its hi part alone (before the value product and
    dV)."""
    if fault is None:
        assert _split_flash_ratio(None) <= 1.0
    else:
        assert _split_flash_ratio(fault) > 1.0


@pytest.mark.parametrize("fault", [None, "drop_chunk", "no_mm", "two_part"])
def test_fp32_split_d256_tiling_within_fp32_tolerance(fault):
    """The split design at head dim 256 (each kernel a pair of CTAs, each
    CTA's score partials over its 128 columns, summed through the
    exchange) lies within the fp32 tolerances of the JAX package's fp32
    flash path; seeded faults fall outside: a D chunk's partial dropped,
    the mid.mid term dropped, and a two-part split."""
    ratio = _split_flash_ratio(fault, d=256)
    assert ratio <= 1.0 if fault is None else ratio > 1.0


def test_fp32_split_p_lo_part_is_below_the_fp32_tolerance():
    """P's lo part is the one part the fp32 contract does not need:
    skipping it moves a P entry by at most 2^-17 of itself, so O and dV
    by at most 2^-17 (7.6e-6) of max|V| and of the dO sums, below the 1e-5
    and 1e-4 tolerances. The kernels keep it (three parts of P, as of
    every fp32 operand); this pins the margin, so that a later PR that
    drops it knows what it gives up."""
    assert _split_flash_ratio("p_lo") <= 1.0


@pytest.mark.parametrize("width", range(16, 257, 16))
def test_flash_design_table(width):
    """Every padded head dim (and the head dim 8 below it, padded to it),
    both dtypes, forward and backward: the tensor-core design, fp32
    through split products at width 64 up to head dim 64, 128 up to 128,
    else 256 (a pair of CTAs, each on 128 columns)."""
    for d in (width - 8, width):
        assert tfa.padded_head_dim(d) == width
        for backward in (False, True):
            assert tfa.design(torch.bfloat16, d, backward) == "tc"
            assert tfa.design(torch.float32, d, backward) == "tc"
        assert tfa.split_width(d) == (64 if d <= 64 else
                                      128 if d <= 128 else 256)

def test_flash_attention_refuses_shapes():
    q = torch.zeros(1, 4, 2, 16)
    with pytest.raises(ValueError, match="Sk >= Sq"):
        tfa.flash_attention(q, q[:, :3], q[:, :3], causal=True)
    with pytest.raises(ValueError, match="repeat kv heads"):
        tfa.flash_attention(q, q[:, :, :1], q[:, :, :1])


# ------------------------------------------------- no jax in the package
def test_package_imports_no_jax():
    code = (
        "import pkgutil, sys, paddle_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "paddle_tpu_torch.__path__, 'paddle_tpu_torch.')]\n"
        "for n in names: __import__(n)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'paddle_tpu.')) or m == 'paddle_tpu']\n"
        "assert not bad, bad\n"
        "assert len(names) >= 15, names\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


# ------------------------------------------- no silent CPU fallback
def test_build_load_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: load() builds there")
    with pytest.raises(RuntimeError, match="CUDA GPU"):
        _build.load()


def test_build_load_raises_without_nvcc(monkeypatch):
    monkeypatch.setattr(_build, "_LIB", None)
    monkeypatch.setattr(_build.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(_build, "_stale", lambda: True)
    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load()


def test_entry_points_raise_without_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    from paddle_tpu_torch import default_device
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    with pytest.raises(RuntimeError, match="CUDA GPU"):
        default_device()
    with pytest.raises(RuntimeError, match="CUDA GPU"):
        LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=1))


def test_cache_dtype_int8_not_ported():
    """int8, once refused here, is now an accepted cache dtype (the
    quantized cache, tests/test_torch_quant.py); an unknown dtype still
    raises ValueError naming the allowed set."""
    from paddle_tpu_torch.models.generation import normalize_cache_dtype

    assert normalize_cache_dtype("int8") == "int8"
    assert normalize_cache_dtype(torch.int8) == "int8"
    with pytest.raises(ValueError, match="allowed"):
        normalize_cache_dtype("float16")
    with pytest.raises(ValueError, match="cache_dtype"):
        normalize_cache_dtype("floatnope")
    assert normalize_cache_dtype(None) == "bfloat16"
    assert normalize_cache_dtype(torch.float32) == "float32"



# -------------------------------------------------- the functionals
def test_sdpa_matches_jax_composed():
    """Causal with sq != sk (bottom-right), an additive mask and a
    boolean mask, against the JAX package's composed attention."""
    from paddle_tpu.nn.functional.attention import _sdpa_ref
    from paddle_tpu_torch.nn import functional as TF

    rng = np.random.RandomState(3)
    q = rng.randn(2, 3, 4, 8).astype(np.float32)
    k = rng.randn(2, 5, 4, 8).astype(np.float32)
    v = rng.randn(2, 5, 4, 8).astype(np.float32)
    add = np.where(rng.rand(2, 1, 3, 5) < 0.3, -np.inf, 0.0).astype(
        np.float32)
    add[..., 0] = 0.0  # every row keeps a column
    keep = add == 0.0
    t = [torch.from_numpy(a) for a in (q, k, v)]
    j = [jnp.asarray(a) for a in (q, k, v)]
    scale = 1.0 / np.sqrt(8.0)
    for causal, tm, jm in ((True, None, None),
                           (False, torch.from_numpy(add), jnp.asarray(add)),
                           (False, torch.from_numpy(keep),
                            jnp.asarray(keep))):
        want = _sdpa_ref(*j, jm, causal=causal, scale=scale, dropout_p=0.0,
                         key=None)
        got = TF.scaled_dot_product_attention(*t, attn_mask=tm,
                                              is_causal=causal)
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5,
                                   atol=1e-6)


def test_rotary_functional_matches_jax():
    """Tables built from the base, full-dim tables, and q/k/v together,
    against paddle_tpu's incubate functional (Pallas rope in interpret
    mode)."""
    from paddle_tpu.core.tensor import Tensor
    from paddle_tpu.incubate.nn import functional as JIF
    from paddle_tpu_torch.nn import functional as TF

    rng = np.random.RandomState(4)
    q, k, v = (rng.randn(2, 6, 2, 16).astype(np.float32) for _ in range(3))
    half_c, half_s = trope.build_rope_cache(6, 16)
    full_c = torch.cat([half_c, half_c], -1)
    full_s = torch.cat([half_s, half_s], -1)
    for tabs in ({}, {"cos": full_c, "sin": full_s}):
        jtabs = {n: Tensor(jnp.asarray(t.numpy())) for n, t in tabs.items()}
        want = JIF.fused_rotary_position_embedding(
            *(Tensor(jnp.asarray(a)) for a in (q, k, v)), **jtabs)
        got = TF.fused_rotary_position_embedding(
            *(torch.from_numpy(a) for a in (q, k, v)), **tabs)
        for g, w in zip(got, want):
            _assert_close(g, w.value, "float32")


def test_swiglu_matches_jax():
    from paddle_tpu.core.tensor import Tensor
    from paddle_tpu.incubate.nn import functional as JIF
    from paddle_tpu_torch.nn import functional as TF

    x = np.random.RandomState(6).randn(3, 10).astype(np.float32)
    _assert_close(TF.swiglu(torch.from_numpy(x)),
                  JIF.swiglu(Tensor(jnp.asarray(x))).value, "float32")
    _assert_close(TF.swiglu(torch.from_numpy(x[:, :5]),
                            torch.from_numpy(x[:, 5:])),
                  JIF.swiglu(Tensor(jnp.asarray(x[:, :5])),
                             Tensor(jnp.asarray(x[:, 5:]))).value, "float32")
