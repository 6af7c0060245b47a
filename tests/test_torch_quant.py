"""The port's quantized serving (int8 KV cache, W8A16 weights) against
the JAX package's.

Inputs come from a seed with numpy and go to both packages; the Pallas
kernels run in interpret mode, as the JAX package's own tests run them.
Tolerances:

- the rounding rules (``quantize_kv``, ``quantize_weight``,
  ``quantize_weight_with_scales``): int8 codes and fp32 scales
  bit-equal (the same fp32 ops, round half to even, the bf16 grid);
- the W8A16 matmul's plain version against ``int8_matmul`` (Pallas,
  interpret) and ``int8_matmul_composed``: fp32 1e-6 relative (the same
  dequantized weight, sums in another order); bf16 one bf16 ulp (2^-7
  relative: the fp32 sums before the one cast may differ in the last
  bit and round apart);
- the int8 paged attention's plain version against
  ``paged_attention_fused`` over ``QuantizedKV`` arenas (Pallas,
  interpret): fp32 1e-5, bf16 3e-2, the bounds of the float flavour;
- the tiny quantized Llama's cache-free logits: 2e-5 absolute + 1e-4
  relative, the slice's bound for fp32 logits through two layers; its
  int8 buffers bit-equal; fp32 greedy streams with an int8 cache
  token for token.

The CUDA kernels are held against these plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.core.tensor import Tensor  # noqa: E402
from paddle_tpu.kernels import int8_matmul as jim  # noqa: E402
from paddle_tpu.kernels import paged_attention as jpa  # noqa: E402
from paddle_tpu.models import LlamaConfig as JConfig  # noqa: E402
from paddle_tpu.models import LlamaForCausalLM as JLlama  # noqa: E402
from paddle_tpu.quantization import kv as jkv  # noqa: E402
from paddle_tpu.quantization import (  # noqa: E402
    quantize_for_serving as j_quantize,
)
from paddle_tpu_torch.convert import (  # noqa: E402
    load_numpy_state,
    numpy_state,
)
from paddle_tpu_torch.kernels import int8_matmul as tim  # noqa: E402
from paddle_tpu_torch.kernels import paged_attention as tpa  # noqa: E402
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM  # noqa: E402
from paddle_tpu_torch.quantization import (  # noqa: E402
    QuantizedLinear,
    quantize_for_serving,
)
from paddle_tpu_torch.quantization import kv as tkv  # noqa: E402
from paddle_tpu_torch.serving import (  # noqa: E402
    PagedKVPool,
    PagedServingEngine,
    ServingEngine,
)

BF16_ULP = 2.0 ** -7
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# few distinct weight shapes ([32, 32] and [32, 64]), so the JAX side
# compiles few eager programs
CFG = dict(vocab_size=64, hidden_size=32, intermediate_size=32,
           num_hidden_layers=2, num_attention_heads=4)
VARIANTS = {"mha": None, "gqa": 2}


def _both(a, dtype):
    jd, td = DTYPES[dtype]
    a = np.asarray(a, np.float32)
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _equal(got, want):
    if isinstance(got, torch.Tensor):
        got = got.numpy()
    np.testing.assert_array_equal(got, np.asarray(want))


# --------------------------------------------------- the rounding rules
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rounding_rules_bit_equal_jax(dtype):
    rng = np.random.RandomState(0)
    kv = rng.randn(3, 5, 2, 16) * rng.choice([1e-3, 1.0, 40.0], (3, 5, 2, 1))
    kv[1, 2, 0] = 0.0  # an all-zero token: scale floored, codes 0
    w = rng.randn(32, 64) * 0.05
    w[:, 7] = 0.0      # an all-zero output channel
    kj, kt = _both(kv, dtype)
    wj, wt = _both(w, dtype)
    for got, want in zip(tkv.quantize_kv(kt), jkv.quantize_kv(kj)):
        _equal(got, want)
    qt, st = tkv.quantize_kv(kt)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    assert not qt[1, 2, 0].any() and float(st[1, 2, 0]) > 0
    for got, want in zip(tim.quantize_weight(wt), jim.quantize_weight(wj)):
        _equal(got, want)
    scales = np.abs(rng.randn(64)).astype(np.float32) * 0.01
    scales[3] = 0.0    # floored at 1e-8
    for got, want in zip(
            tim.quantize_weight_with_scales(wt, torch.from_numpy(scales)),
            jim.quantize_weight_with_scales(wj, jnp.asarray(scales))):
        _equal(got, want)
    # and the dequantized cache is the same
    _equal(tkv.dequantize_kv(qt, st, torch.float32),
           jkv.dequantize_kv(*jkv.quantize_kv(kj), jnp.float32))


# ------------------------------------------------------ W8A16 matmul
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_int8_matmul_plain_matches_jax(dtype):
    rng = np.random.RandomState(0)
    xj, xt = _both(rng.randn(16, 64), dtype)
    w = rng.randn(64, 256).astype(np.float32)
    wqj, scj = jim.quantize_weight(jnp.asarray(w))
    wqt, sct = tim.quantize_weight(torch.from_numpy(w))
    got = tim.int8_matmul(xt, wqt, sct)
    assert got.dtype == xt.dtype and tuple(got.shape) == (16, 256)
    rtol = BF16_ULP if dtype == "bfloat16" else 1e-6
    wants = [jim.int8_matmul_composed(xj, wqj, scj)] + [
        jim.int8_matmul(xj, wqj, scj, block_rows=br, block_cols=bc)
        for br, bc in ((8, 128), (16, 256), (4, 128))]
    for want in wants:
        np.testing.assert_allclose(_np(got), _np(want), rtol=rtol,
                                   atol=1e-6)
    # leading dims pass through, as in the JAX function
    got3 = tim.int8_matmul(xt.reshape(2, 8, 64), wqt, sct)
    assert torch.equal(got3.reshape(16, 256), got)


# ------------------------------------------------ int8 paged attention
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_int8_paged_attention_plain_matches_jax(dtype):
    """GQA (2 kv heads for 4 query heads), as the JAX package's own pin;
    the tiny Llama's streams below cover MHA through the same path."""
    rng = np.random.RandomState(5)
    b, pages, ps, h, kvh, d = 2, 4, 8, 4, 2, 16
    n = b * pages + 1
    qj, qt = _both(rng.randn(b, 1, h, d), dtype)
    kj, kt = _both(rng.randn(n, ps, kvh, d), dtype)
    vj, vt = _both(rng.randn(n, ps, kvh, d), dtype)
    tbl = (1 + np.arange(b * pages).reshape(b, pages)).astype(np.int32)
    tbl[0, 2:] = 0  # row 0 holds 2 pages; its tail points at page 0
    pos = np.array([13, 27], np.int32)
    kq_j = jkv.QuantizedKV(*jkv.quantize_kv(kj))
    vq_j = jkv.QuantizedKV(*jkv.quantize_kv(vj))
    kq_t = tkv.QuantizedKV(*tkv.quantize_kv(kt))
    vq_t = tkv.QuantizedKV(*tkv.quantize_kv(vt))
    want = jpa.paged_attention_fused(qj, kq_j, vq_j, jnp.asarray(tbl),
                                     jnp.asarray(pos))
    got = tpa.paged_attention(qt, kq_t, vq_t, torch.from_numpy(tbl),
                              torch.from_numpy(pos))
    assert got.dtype == qt.dtype and tuple(got.shape) == tuple(qt.shape)
    tol = 3e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


# ----------------------------------------------- the tiny quantized Llama
_PAIRS = {}


def _pair(variant):
    """(JAX, port) tiny Llamas with the same fp32 weights, each quantized
    by its own package; built once per module."""
    if variant not in _PAIRS:
        kw = dict(CFG, num_key_value_heads=VARIANTS[variant])
        paddle.seed(5)
        jnet = JLlama(JConfig.tiny(**kw))
        jnet.eval()
        tnet = LlamaForCausalLM(LlamaConfig.tiny(**kw), device="cpu",
                                seed=1)
        load_numpy_state(tnet, {k: np.asarray(p.value)
                                for k, p in jnet.named_parameters()})
        _PAIRS[variant] = (j_quantize(jnet), quantize_for_serving(tnet))
    return _PAIRS[variant]


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def qnets(request):
    return _pair(request.param)


def _jax_state(jq):
    out = {k: np.asarray(p.value) for k, p in jq.named_parameters()}
    out.update({k: np.asarray(b.value) for k, b in jq.named_buffers()})
    return out


def test_quantized_llama_matches_jax(qnets):
    jq, tq = qnets
    # every projection and the head became a QuantizedLinear
    qlayers = [m for m in tq.modules() if isinstance(m, QuantizedLinear)]
    assert len(qlayers) == CFG["num_hidden_layers"] * 6 + 1
    assert not any("proj" in k for k, _ in tq.named_parameters())
    # the buffers are JAX's, bit for bit
    jstate, tstate = _jax_state(jq), numpy_state(tq)
    assert set(jstate) == set(tstate)
    for k, v in jstate.items():
        if k.endswith(("weight_q", "weight_scale")):
            assert tstate[k].dtype == v.dtype, k
            np.testing.assert_array_equal(tstate[k], v, err_msg=k)
    # cache-free logits
    ids = np.random.RandomState(3).randint(0, 64, (2, 7)).astype(np.int32)
    want = np.asarray(jq(Tensor(jnp.asarray(ids))).numpy(), np.float32)
    with torch.no_grad():
        got = tq(torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)
    # convert carries JAX's quantized buffers across (into a model that
    # quantize_for_serving shaped) and back
    other = quantize_for_serving(LlamaForCausalLM(tq.config, device="cpu",
                                                  seed=9))
    load_numpy_state(other, jstate)
    back = numpy_state(other)
    for k, v in jstate.items():
        np.testing.assert_array_equal(back[k], np.asarray(v, back[k].dtype),
                                      err_msg=k)
    with pytest.raises(TypeError, match="weight_q"):
        load_numpy_state(other, dict(jstate, **{
            "lm_head.weight_q": jstate["lm_head.weight_q"].astype(
                np.float32)}))
    # idempotent: a second pass re-rounds nothing, in place or not
    again = quantize_for_serving(tq)
    assert again is not tq
    same = quantize_for_serving(tq, inplace=True)
    assert same is tq
    for state in (numpy_state(again), numpy_state(same)):
        for k, v in tstate.items():
            np.testing.assert_array_equal(state[k], v, err_msg=k)


def test_quantize_for_serving_refuses_observed_layers():
    class ObservedLayer(torch.nn.Module):  # the JAX PTQ/QAT wrapper's name
        pass

    model = torch.nn.Sequential(ObservedLayer())
    with pytest.raises(NotImplementedError, match="queue A item 3"):
        quantize_for_serving(model)


def test_int8_streams_equal_jax_generate():
    """generate(cache_dtype="int8") and both engines with an int8 cache,
    fp32 weights quantized to int8, against JAX ``generate``: two
    prompts in one JAX batch; the second request stops earlier (a greedy
    stream's prefix), and with one row it is admitted only when the
    first finishes, so its prefill is adopted into a used row."""
    jq, tq = _pair("gqa")
    prompts = np.random.RandomState(11).randint(0, 64, (2, 6))
    want = np.asarray(jq.generate(Tensor(jnp.asarray(prompts)),
                                  max_new_tokens=8,
                                  cache_dtype="int8").numpy())
    got = tq.generate(prompts, max_new_tokens=8, cache_dtype="int8")
    np.testing.assert_array_equal(got.numpy(), want)
    news = (8, 5)
    for eng in (ServingEngine(tq, max_batch_size=1, max_seq_len=32,
                              min_bucket=8, cache_dtype="int8"),
                PagedServingEngine(tq, max_batch_size=1, max_seq_len=32,
                                   min_bucket=8, page_size=4,
                                   cache_dtype="int8")):
        assert isinstance(eng._caches[0][0], tkv.QuantizedKV)
        handles = [eng.submit(p, m) for p, m in zip(prompts, news)]
        eng.run_until_idle()
        for h, w, m in zip(handles, want, news):
            assert h.status == "DONE"
            np.testing.assert_array_equal(h.output_ids, w[:6 + m])
        assert eng.pool.occupancy == 0
        assert handles[1].admitted_step >= handles[0].finished_step
    assert eng.page_pool.pages_in_use == 0


def test_int8_admits_more_rows_at_equal_bytes():
    """At the page-arena bytes of a bf16 pool (the int8 scales counted),
    an int8 pool admits >= 1.8x the concurrent requests (head dim 64:
    1 + 4/64 bytes an element against 2, 1.88x the slots; 9 against 5
    three-page requests), as ``tests/test_serving.py`` pins for JAX."""
    cfg = LlamaConfig.tiny(vocab_size=64, hidden_size=128,
                           intermediate_size=128, num_hidden_layers=1,
                           num_attention_heads=2)
    net = LlamaForCausalLM(cfg, device="cpu", seed=9)
    kw = dict(max_batch_size=12, max_seq_len=64, min_bucket=8, page_size=8,
              max_prefills_per_step=None)
    bf16 = PagedServingEngine(net, num_pages=15, cache_dtype="bfloat16",
                              **kw)
    budget = bf16.page_pool.arena_bytes()
    probe = PagedKVPool(cfg, page_size=8, num_pages=1, dtype="int8",
                        max_seq_len=64, device="cpu")
    assert probe.page_bytes() == 2 * 8 * 2 * (64 + 4)
    int8 = PagedServingEngine(net, num_pages=budget // probe.page_bytes()
                              - 1, cache_dtype="int8", **kw)
    assert int8.page_pool.arena_bytes() <= budget
    prompts = np.random.RandomState(3).randint(0, 64, (10, 20))
    hb = [bf16.submit(p, 4) for p in prompts]
    hq = [int8.submit(p, 4) for p in prompts]
    bf16.step()
    int8.step()
    assert bf16.active_slots == 5 and int8.active_slots == 9
    assert int8.active_slots >= 1.8 * bf16.active_slots
    bf16.run_until_idle()
    int8.run_until_idle()
    assert all(h.status == "DONE" for h in hb + hq)
    assert int8.page_pool.pages_in_use == 0
