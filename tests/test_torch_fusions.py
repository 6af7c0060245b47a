"""The port's two float fusions against the JAX package's.

``paddle_tpu_torch.kernels.fused_norm_matmul`` (RMSNorm + matmul, the
Llama head) and ``fused_rope_attention`` (rope applied inside attention)
run their plain versions on the CPU; the JAX side runs
``rms_norm_matmul`` and ``rope_attention_fused`` in Pallas interpret mode
with explicit small blocks, as ``tests/test_kernel_autotune.py`` does,
and its Llama takes both fused paths through tune-cache entries recorded
in a throwaway cache file. Inputs are made with numpy and handed to both.
Tolerances:

- plain version against the JAX kernel, fp32: 1e-5 of the largest
  entry (the same fp32 math, summed in other orders); bf16: entry by
  entry, 2^-7 of the entry plus that fp32 tolerance (both sides compute
  in fp32 and cast once, so the two may round one ulp apart);
- gradients against ``jax.grad`` of the same loss, fp32: 1e-5 of the
  largest entry of each gradient (both backward passes are the VJP of the
  same composed function);
- the tiny Llama's logits and every parameter gradient: 2e-5 absolute +
  1e-4 relative (the existing model bound, ``tests/test_torch_llama.py``);
- the fused fp32 greedy ``generate``: token for token equal to the
  unfused one.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
import paddle_tpu.kernels.autotune as at  # noqa: E402
from paddle_tpu.core import tape  # noqa: E402
from paddle_tpu.core.tensor import Tensor  # noqa: E402
from paddle_tpu.kernels import fused_norm_matmul as jfnm  # noqa: E402
from paddle_tpu.kernels import fused_rope_attention as jfra  # noqa: E402
from paddle_tpu.kernels.rope import build_rope_cache  # noqa: E402
from paddle_tpu.models import LlamaConfig as JConfig  # noqa: E402
from paddle_tpu.models import LlamaForCausalLM as JLlama  # noqa: E402
from paddle_tpu.models import causal_lm_loss as jloss  # noqa: E402
from paddle_tpu_torch.convert import load_numpy_state, numpy_state  # noqa
from paddle_tpu_torch.kernels import fused_norm_matmul as tfnm  # noqa: E402
from paddle_tpu_torch.kernels import fused_rope_attention as tfra  # noqa
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM  # noqa
from paddle_tpu_torch.models import causal_lm_loss  # noqa: E402
from paddle_tpu_torch.nn import functional as TF  # noqa: E402
from test_torch_kernels import _one_thread  # noqa: E402,F401  (autouse)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL32 = 1e-5
ATOL, RTOL = 2e-5, 1e-4
BOTH = ("rms_norm_matmul", "rope_attention")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _both(a, dtype):
    jd, td = DTYPES[dtype]
    a = np.asarray(a, np.float32)
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _cast_once_close(got, want, dtype):
    """fp32: within TOL32 of the largest entry; bf16: each entry within
    2^-7 of itself plus that."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    top = float(np.abs(want).max())
    tol = TOL32 * top
    if dtype == "bfloat16":
        tol = 2.0 ** -7 * np.abs(want) + tol
    assert (np.abs(got - want) <= tol).all(), float(
        np.abs(got - want).max())


# ------------------------------------------------ the two plain versions
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_norm_matmul_plain_matches_jax_kernel(dtype):
    rng = np.random.RandomState(0)
    jx, tx = _both(rng.randn(2, 8, 64), dtype)
    w = rng.randn(64).astype(np.float32)  # the norm weight stays fp32
    jm, tm = _both(rng.randn(64, 256), dtype)
    want = jfnm.rms_norm_matmul(jx, jnp.asarray(w), jm, eps=1e-5,
                                block_rows=8, block_cols=128)
    got = tfnm.rms_norm_matmul(tx, torch.from_numpy(w), tm, 1e-5)
    assert got.dtype == tx.dtype and tuple(got.shape) == (2, 8, 256)
    _cast_once_close(got, want, dtype)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rope_attention_plain_matches_jax_kernel(dtype, causal, d=16):
    b, s, h = 2, 64, 4
    rng = np.random.RandomState(1)
    (jq, tq), (jk, tk), (jv, tv) = (_both(rng.randn(b, s, h, d), dtype)
                                    for _ in range(3))
    cos, sin = build_rope_cache(s, d)
    want = jfra.rope_attention_fused(jq, jk, jv, cos, sin, causal=causal,
                                     block_q=16)
    tcos, tsin = (torch.tensor(np.asarray(t)) for t in (cos, sin))
    got = tfra.rope_attention_fused(tq, tk, tv, tcos, tsin, causal=causal)
    assert got.dtype == tq.dtype
    _cast_once_close(got, want, dtype)
    # the [S, D/2] table layout gives the same function
    got2 = tfra.rope_attention_reference(tq, tk, tv, tcos[0, :, 0],
                                         tsin[0, :, 0], causal=causal)
    assert torch.equal(got, got2)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rope_attention_plain_matches_jax_kernel_d80(dtype):
    """Head dim 80 (the card runs it on the 128-wide kernel): the TPU
    kernel rotates column c with c + 40, the true half; a pairing at the
    padded half would give finite, wrong outputs."""
    test_rope_attention_plain_matches_jax_kernel(dtype, True, d=80)


# ------------------------------------------------- the two backward passes
def _grads_close(got, want):
    for g, w in zip(got, want):
        w = _np(w)
        np.testing.assert_allclose(_np(g), w, rtol=0,
                                   atol=TOL32 * float(np.abs(w).max()))


def test_norm_matmul_grads_match_jax():
    rng = np.random.RandomState(2)
    x, w, m = (rng.randn(*sh).astype(np.float32)
               for sh in ((16, 64), (64,), (64, 128)))
    g = rng.randn(16, 128).astype(np.float32)
    want = jax.jit(jax.grad(lambda a, b, c: (jfnm.rms_norm_matmul(
        a, b, c, eps=1e-5, block_rows=8, block_cols=64) * g).sum(),
        argnums=(0, 1, 2)))(jnp.asarray(x), jnp.asarray(w), jnp.asarray(m))
    ins = [torch.from_numpy(t).requires_grad_(True) for t in (x, w, m)]
    out = tfnm.rms_norm_matmul(*ins, 1e-5)
    got = torch.autograd.grad((out * torch.from_numpy(g)).sum(), ins)
    _grads_close(got, want)


def test_rope_attention_grads_match_jax():
    b, s, h, d = 2, 32, 2, 16
    rng = np.random.RandomState(3)
    q, k, v, g = (rng.randn(b, s, h, d).astype(np.float32) for _ in range(4))
    cos, sin = build_rope_cache(s, d)
    want = jax.jit(jax.grad(lambda a, bb, c: (jfra.rope_attention_fused(
        a, bb, c, cos, sin, block_q=16) * g).sum(), argnums=(0, 1, 2)))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ins = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    tcos, tsin = (torch.tensor(np.asarray(t)) for t in (cos, sin))
    out = tfra.rope_attention_fused(*ins, tcos, tsin)
    got = torch.autograd.grad((out * torch.from_numpy(g)).sum(), ins)
    _grads_close(got, want)


# ---------------------------------------------------- the fused tiny Llama
@pytest.fixture
def tune_cache(tmp_path, monkeypatch):
    """A throwaway JAX tune cache (the fused paths' opt-in)."""
    monkeypatch.setenv(at.ENV_CACHE, str(tmp_path / "tune_cache.json"))
    at.reset_cache()
    yield at.get_cache()
    at.reset_cache()


def test_tiny_llama_fused_logits_and_grads_match_jax(tune_cache):
    """MHA tiny Llama (hidden 64, 4 heads of 16, vocab 1000), B 2 x S 32:
    the JAX model on both fused paths (tune-cache entries for these
    shapes) against the port with both fusions."""
    b, s = 2, 32
    cfg = dict(vocab_size=1000, hidden_size=64, intermediate_size=128,
               num_hidden_layers=2, num_attention_heads=4,
               max_position_embeddings=64)
    # two blocks each way: few interpreted grid steps
    tune_cache.record("rope_attention", at.rope_attention_sig(b, s, 4, 16),
                      {"block_q": 16}, save=False)
    tune_cache.record("rms_norm_matmul", at.norm_matmul_sig(b * s, 64, 1000),
                      {"block_rows": 32, "block_cols": 500}, save=False)
    paddle.seed(7)
    jnet = JLlama(JConfig(**cfg))
    params = {k: p.value for k, p in jnet.named_parameters()}
    tnet = LlamaForCausalLM(LlamaConfig(**cfg), device="cpu", seed=1,
                            fusions=BOTH)
    load_numpy_state(tnet, {k: np.asarray(v) for k, v in params.items()})
    ids = np.random.RandomState(4).randint(0, 1000, (b, s + 1))
    ids, labels = ids[:, :-1].astype(np.int32), ids[:, 1:].astype(np.int32)

    sel = at.selection_counter().series()

    def f(params):
        jnet.load_functional_state(params)
        with tape.trace_scope(), tape.no_grad():
            logits = jnet(Tensor(jnp.asarray(ids)))
            loss = jloss(logits, Tensor(jnp.asarray(labels))).mean()
            return loss.value, logits.value

    (want_loss, want_logits), want_grads = jax.jit(jax.value_and_grad(
        f, has_aux=True))(params)
    jnet.load_functional_state(params)
    after = at.selection_counter().series()
    for kernel in BOTH:  # the JAX model did take both fused paths
        key = (("kernel", kernel), ("path", "fused:cached"))
        assert after.get(key, 0) > sel.get(key, 0), kernel

    logits = tnet(torch.from_numpy(ids).long())
    np.testing.assert_allclose(_np(logits), _np(want_logits), atol=ATOL,
                               rtol=RTOL)
    loss = causal_lm_loss(logits, torch.from_numpy(labels).long()).mean()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    got = dict(tnet.named_parameters())
    assert set(got) == set(want_grads)
    for k, p in got.items():
        np.testing.assert_allclose(_np(p.grad), _np(want_grads[k]),
                                   atol=ATOL, rtol=RTOL, err_msg=k)


def test_fused_generate_equals_unfused_and_state_round_trips():
    net = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu", seed=5)
    ids = np.random.RandomState(6).randint(0, 1000, (2, 9))
    want = net.generate(ids, max_new_tokens=6, cache_dtype="float32")
    net.fusions = BOTH
    got = net.generate(ids, max_new_tokens=6, cache_dtype="float32")
    assert torch.equal(got, want)
    # a model built with fusions carries the same parameters
    other = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu", seed=0,
                             fusions=BOTH)
    load_numpy_state(other, numpy_state(net))
    assert all(torch.equal(a, b) for a, b in zip(net.parameters(),
                                                 other.parameters()))


# --------------------------------------------------------- eligibility
class _Spy:
    def __init__(self, monkeypatch, name):
        self.calls = 0
        real = getattr(TF, name)

        def spy(*a, **kw):
            self.calls += 1
            return real(*a, **kw)
        monkeypatch.setattr(TF, name, spy)


def test_rope_attention_eligibility(monkeypatch):
    """Fused only in the cache-free, unmasked MHA forward with S >= 8;
    GQA, a mask, a cache or a short sequence keeps it unfused."""
    spy = _Spy(monkeypatch, "rope_attention")
    rng = np.random.RandomState(8)
    ids = torch.from_numpy(rng.randint(0, 1000, (1, 8))).long()
    mha = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu",
                           fusions={"rope_attention"})
    gqa = LlamaForCausalLM(LlamaConfig.tiny(num_key_value_heads=2),
                           device="cpu", fusions={"rope_attention"})
    with torch.inference_mode():
        want = gqa(ids)
        gqa.fusions = ()
        assert torch.equal(gqa(ids), want)
        assert spy.calls == 0
        mha(ids[:, :7])                                 # S < 8
        mask = torch.zeros(1, 1, 8, 8)
        mha(ids, attn_mask=mask)                        # a mask
        mha.generate(ids, max_new_tokens=2, cache_dtype="float32")
        assert spy.calls == 0
        mha(ids)
        assert spy.calls == mha.config.num_hidden_layers


def test_head_fusion_eligibility_and_names(monkeypatch):
    """The head fuses only with a dense float lm_head; a tied or a
    quantized head keeps the unfused norm -> head; unknown names raise."""
    from paddle_tpu_torch.quantization import quantize_for_serving

    spy = _Spy(monkeypatch, "rms_norm_matmul")
    ids = torch.from_numpy(np.random.RandomState(9).randint(0, 1000, (1, 4)))
    tied = LlamaForCausalLM(LlamaConfig.tiny(tie_word_embeddings=True),
                            device="cpu", fusions={"rms_norm_matmul"})
    quant = quantize_for_serving(LlamaForCausalLM(
        LlamaConfig.tiny(), device="cpu", fusions={"rms_norm_matmul"}))
    with torch.inference_mode():
        tied(ids.long())
        quant(ids.long())
        assert spy.calls == 0
        dense = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
        want = dense(ids.long())
        dense.fusions = {"rms_norm_matmul"}
        got = dense(ids.long())
        assert spy.calls == 1
        np.testing.assert_allclose(_np(got), _np(want), atol=ATOL, rtol=RTOL)
    with pytest.raises(ValueError, match="unknown fusions"):
        LlamaForCausalLM(LlamaConfig.tiny(), device="cpu",
                         fusions={"flash_attention"})
    with pytest.raises(ValueError, match="unknown fusions"):
        dense.fusions = {"rope"}
    assert dense.fusions == frozenset({"rms_norm_matmul"})


# ------------------------- the tensor-core kernels' order of work (bf16)
def _bf16(x):
    return x.to(torch.bfloat16).float()


def _emulate_tc_head(x, w, wm, eps, kchunk, fault=None):
    """The bf16 tensor-core fused head's order of work in plain PyTorch:
    the rstd pre-pass (fp32 over the whole row), y = (x * rstd) * w in
    fp32 rounded to bf16, the products over K in chunks of ``kchunk``
    rows, each chunk's fp32 partial summed in chunk order, one cast.
    ``fault``: "y_unrounded" (y kept in fp32), "neighbour_rstd" (each row
    takes the previous row's rstd), "skip_chunk" (the second K chunk is
    left out)."""
    xf = x.float()
    rstd = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    if fault == "neighbour_rstd":
        rstd = torch.roll(rstd, 1, dims=0)
    y = (xf * rstd) * w.float()
    if fault != "y_unrounded":
        y = _bf16(y)
    out = torch.zeros(x.shape[0], wm.shape[1])
    for i, k0 in enumerate(range(0, x.shape[1], kchunk)):
        if fault == "skip_chunk" and i == 1:
            continue
        out = out + y[:, k0:k0 + kchunk] @ wm[k0:k0 + kchunk].float()
    return out.to(torch.bfloat16)


@pytest.mark.parametrize("case", ["swap", "tiled", "y_unrounded",
                                  "neighbour_rstd", "skip_chunk"])
def test_tc_head_order_of_work_within_slack(case):
    """The bf16 fused head's tensor-core order of work (emulated: the
    swap-AB kernel's K chunks for the H100's 132 SMs, or the tiled
    kernel's one pass over K) lies within cast-once plus
    ``normed_rounding_slack`` of the Pallas kernel (interpret mode);
    three seeded faults each fall outside it."""
    rng = np.random.RandomState(10)
    rows, h, n = 16, 512, 384
    jx, tx = _both(rng.randn(rows, h), "bfloat16")
    jw, tw = _both(1 + 0.1 * rng.randn(h), "bfloat16")
    jm, tm = _both(0.05 * rng.randn(h, n), "bfloat16")
    want = _np(jfnm.rms_norm_matmul(jx, jw, jm, eps=1e-5, block_rows=8,
                                    block_cols=128))
    kchunk = h if case == "tiled" else tfnm.swap_kchunk(
        h, n, 132, tfnm.SWAP_CTAS_PER_SM)
    assert case == "tiled" or h // kchunk >= 4  # several chunks to sum
    fault = None if case in ("swap", "tiled") else case
    got = _np(_emulate_tc_head(tx, tw, tm, 1e-5, kchunk, fault))
    tol = 2.0 ** -7 * np.abs(want) + TOL32 * float(np.abs(want).max()) \
        + _np(tfnm.normed_rounding_slack(tx, tw, tm, 1e-5))
    ratio = float((np.abs(got - want) / tol).max())
    assert (ratio <= 1.0) == (fault is None), ratio


def _split(x):
    """fp32 x -> (bf16(x), bf16(x - bf16(x))), both as fp32."""
    hi = _bf16(x)
    return hi, _bf16(x - hi)


def _emulate_tc_rope(q, k, v, cos2, sin2, fault=None):
    """The bf16 tensor-core rope-on-load kernel's order of work (causal)
    in plain PyTorch, in fp32 before its final cast: q and k rotated in
    fp32 and split into bf16 hi and lo parts, S = q_hi k_lo^T + q_lo
    k_hi^T + q_hi k_hi^T, an online softmax over q tiles of 64 rows and
    k blocks of 128 in the log2 domain, P split the same way and O += P_lo
    V + P_hi V, l summed from the unsplit P. ``fault``: "drop_qlo_khi"
    (the q_lo k_hi^T product left out), "p_bf16" (P rounded to bf16: the
    departure from the JAX contract), "k_neighbour" (k rotated by the
    previous position's table row)."""
    qt, kt, vt = (t.transpose(1, 2).float() for t in (q, k, v))
    c, s = cos2[None, None], sin2[None, None]
    rq = tfra._rotate(qt, c, s)
    if fault == "k_neighbour":
        c, s = (torch.roll(t, 1, dims=2) for t in (c, s))
    (qh, ql), (kh, kl) = _split(rq), _split(tfra._rotate(kt, c, s))
    seq, d = qt.shape[2], qt.shape[3]
    sl2 = math.log2(math.e) / math.sqrt(d)
    out = torch.zeros_like(qt)
    for q0 in range(0, seq, 64):
        rows = slice(q0, q0 + 64)
        n_r = min(64, seq - q0)
        m = torch.full(qt.shape[:2] + (n_r, 1), -math.inf)
        l = torch.zeros_like(m)
        acc = torch.zeros(qt.shape[:2] + (n_r, d))
        for k0 in range(0, q0 + 64, 128):
            cols = slice(k0, k0 + 128)
            sc = qh[:, :, rows] @ kl[:, :, cols].transpose(-1, -2)
            if fault != "drop_qlo_khi":
                sc = sc + ql[:, :, rows] @ kh[:, :, cols].transpose(-1, -2)
            sc = (sc + qh[:, :, rows] @ kh[:, :, cols].transpose(-1, -2)) \
                * sl2
            r = torch.arange(q0, q0 + n_r)[:, None]
            cc = torch.arange(k0, k0 + sc.shape[-1])[None, :]
            sc = sc.masked_fill(cc > r, -math.inf)
            m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(sc - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            ph, pl = ((_bf16(p), torch.zeros_like(p)) if fault == "p_bf16"
                      else _split(p))
            acc = acc * alpha + pl @ vt[:, :, cols] + ph @ vt[:, :, cols]
            m = m_new
        out[:, :, rows] = acc / l
    return out.transpose(1, 2)


@pytest.mark.parametrize("fault", [None, "drop_qlo_khi", "p_bf16",
                                   "k_neighbour"])
def test_tc_rope_attention_split_products_within_slack(fault):
    """The bf16 rope-on-load kernel's split products (emulated) lie within
    ``split_product_slack`` of the JAX kernel (interpret mode, fed the
    same bf16 values in fp32, so both sides stop before the final cast);
    three seeded faults each fall outside it, among them rounding P to
    bf16, which shows that the slack holds the fp32 contract."""
    rng = np.random.RandomState(11)
    b, s, h, d = 1, 256, 2, 64
    arrs = [_np(torch.from_numpy(rng.randn(b, s, h, d).astype(np.float32))
                .bfloat16()) for _ in range(3)]
    cos, sin = build_rope_cache(s, d)
    want = _np(jfra.rope_attention_fused(*(jnp.asarray(a) for a in arrs),
                                         cos, sin, causal=True, block_q=128))
    tq, tk, tv = (torch.from_numpy(a.copy()) for a in arrs)
    tcos, tsin = (torch.tensor(np.asarray(t))[0, :, 0] for t in (cos, sin))
    slack = _np(tfra.split_product_slack(tq, tk, tv, tcos, tsin))
    got = _np(_emulate_tc_rope(tq, tk, tv, tcos, tsin, fault))
    ratio = float((np.abs(got - want) / slack).max())
    assert (ratio <= 1.0) == (fault is None), ratio
