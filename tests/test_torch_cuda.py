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
fp32 tolerance, by which the values before the cast may differ.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu_torch.kernels import flash_attention as tfa  # noqa: E402
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


def _cast_once_ok(got, want, tol32):
    """fp32: within ``tol32`` of the largest entry; bf16: each entry
    within 2^-7 of it plus that fp32 tolerance."""
    if got.dtype == torch.float32:
        return _rel_ok(got, want, tol32)
    ref = want.float().abs()
    tol = 2.0 ** -7 * ref + tol32 * float(ref.max())
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
@pytest.mark.parametrize("d", [64, 128, 256])
def test_paged_attention_kernel(dev, dtype, kvh, d):
    args = _arena(dev, DTYPES[dtype], kvh, d, seed=kvh * 1000 + d)
    got = tpa.paged_attention(*args)
    want = tpa.paged_attention_reference(*args)
    assert got.dtype == args[0].dtype and torch.isfinite(got).all()
    assert _err(got, want) <= PAGED[dtype]


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
    "causal_sq_lt_sk": (True, 70, 200, 64, False),
    "full": (False, 100, 77, 128, False),
    "causal_strided": (True, 96, 96, 64, True),
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
    assert o.dtype == dt and torch.isfinite(o).all()
    assert _cast_once_ok(o, ro, 1e-5)
    assert _err(lse, rlse) <= 1e-5 * float(rlse.abs().max())
    grads = tfa.flash_attention_backward_cuda(q, k, v, o, lse, do, causal)
    want = tfa.flash_attention_backward_reference(q, k, v, o, lse, do,
                                                  causal)
    for got, ref in zip(grads, want):
        assert got.dtype == dt and torch.isfinite(got).all()
        assert _cast_once_ok(got, ref, 1e-4)
    # no float atomics: the gradients repeat bit for bit
    again = tfa.flash_attention_backward_cuda(q, k, v, o, lse, do, causal)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


@pytest.mark.cuda
def test_flash_attention_refuses_what_it_does_not_take(dev):
    q = torch.randn(1, 8, 2, 256, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention_cuda(q, q, q)
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
