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
  backward products in bf16, the port keeps every product in fp32.

The CUDA kernels themselves are compared with their plain versions on
the card, by tests/test_torch_cuda.py and chip_smoke.py.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from paddle_tpu.kernels import flash_attention as jfa  # noqa: E402
from paddle_tpu.kernels import paged_attention as jpa  # noqa: E402
from paddle_tpu.kernels import rope as jrope  # noqa: E402
from paddle_tpu.kernels.rms_norm import rms_norm_fused  # noqa: E402
from paddle_tpu_torch.kernels import _build  # noqa: E402
from paddle_tpu_torch.kernels import flash_attention as tfa  # noqa: E402
from paddle_tpu_torch.kernels import paged_attention as tpa  # noqa: E402
from paddle_tpu_torch.kernels import rms_norm as trms  # noqa: E402
from paddle_tpu_torch.kernels import rope as trope  # noqa: E402

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
def _paged_inputs(dtype, kvh, h=4, d=16):
    rng = np.random.RandomState(5)
    b, pages, ps = 2, 4, 8
    n = b * pages + 1
    q = rng.randn(b, 1, h, d)
    kp = rng.randn(n, ps, kvh, d)
    vp = rng.randn(n, ps, kvh, d)
    tbl = (1 + np.arange(b * pages).reshape(b, pages)).astype(np.int32)
    tbl[0, 2:] = 0  # row 0 holds 2 pages; its tail points at page 0
    pos = np.array([13, 27], np.int32)
    j = [_both(a, dtype)[0] for a in (q, kp, vp)]
    t = [_both(a, dtype)[1] for a in (q, kp, vp)]
    j += [jnp.asarray(tbl), jnp.asarray(pos)]
    t += [torch.from_numpy(tbl), torch.from_numpy(pos)]
    return j, t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kvh", [4, 2], ids=["mha", "gqa"])
@pytest.mark.parametrize("ref", ["fused", "reference", "composed"])
def test_paged_attention_plain_matches_jax(dtype, kvh, ref):
    (qj, kj, vj, tj, pj), (qt, kt, vt, tt, pt) = _paged_inputs(dtype, kvh)
    fn = {"fused": jpa.paged_attention_fused,
          "reference": jpa.paged_attention_reference,
          "composed": jpa.paged_attention_composed}[ref]
    want = fn(qj, kj, vj, tj, pj)
    got = tpa.paged_attention(qt, kt, vt, tt, pt)
    assert got.dtype == qt.dtype and tuple(got.shape) == tuple(qt.shape)
    tol = 3e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


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
    "causal": (True, 8, 8),
    "causal_sq_lt_sk": (True, 5, 9),
    "full": (False, 6, 9),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention_matches_jax(dtype, case):
    causal, sq, sk = FLASH_CASES[case]
    rng = np.random.RandomState(12)
    b, h, d = 2, 3, 16
    qn, kn, vn = (rng.randn(b, n, h, d) for n in (sq, sk, sk))
    gn = rng.randn(b, sq, h, d)
    (qj, qt), (kj, kt), (vj, vt), (gj, gt) = (
        _both(a, dtype) for a in (qn, kn, vn, gn))
    scale = 1.0 / np.sqrt(d)
    want_o, vjp = jax.vjp(
        lambda q, k, v: jfa.flash_attention_fwd(q, k, v, causal=causal,
                                                scale=scale), qj, kj, vj)
    want = vjp(gj)
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
