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
  bit and round apart); also at the tensor-core kernels' shapes (64 and
  130 rows, K 1040, not a multiple of their 64-row k-tile), where entries
  near zero of sums over 1040 terms also get 1e-6 of the largest entry;
- an emulation of the bf16 tensor-core kernels' order of work (the
  weight dequantized tile by tile, fp32 sums k-tile by k-tile, split-K
  partials summed in chunk order) against the plain version: the card's
  cast-once tolerance, 2^-7 of each entry + 1e-5 of the largest; two
  seeded faults (a skipped k-tile, a column's scale taken from its
  neighbour) must fall outside it;
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
from test_torch_kernels import _one_thread  # noqa: E402,F401  (autouse)

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


@pytest.mark.parametrize("d", [72, 40])
def test_kv_codes_bit_equal_jax_at_odd_head_dims(d):
    """The KV cache's int8 codes and scales at head dims that are not
    multiples of 16 (the int8 arena's rows are then not a multiple of 16
    bytes), bit-equal to JAX's."""
    rng = np.random.RandomState(d)
    kj, kt = _both(rng.randn(3, 5, 2, d) * 3.0, "float32")
    for got, want in zip(tkv.quantize_kv(kt), jkv.quantize_kv(kj)):
        _equal(got, want)


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


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("rows", [64, 130])
def test_int8_matmul_plain_matches_jax_at_kernel_shapes(dtype, rows):
    """The tensor-core kernels' row counts (64: one swap-AB x tile; 130:
    a ragged one) and K 1040, not a multiple of their 64-row k-tile."""
    rng = np.random.RandomState(rows)
    k, n = 1040, 256
    xj, xt = _both(rng.randn(rows, k), dtype)
    w = (0.02 * rng.randn(k, n)).astype(np.float32)
    wqj, scj = jim.quantize_weight(jnp.asarray(w))
    wqt, sct = tim.quantize_weight(torch.from_numpy(w))
    got = tim.int8_matmul(xt, wqt, sct)
    rtol = BF16_ULP if dtype == "bfloat16" else 1e-6
    for want in (jim.int8_matmul_composed(xj, wqj, scj),
                 jim.int8_matmul(xj, wqj, scj, block_rows=rows,
                                 block_cols=128)):
        # fp32 sums over 1040 terms in another order: entries near zero
        # also get 1e-6 of the largest entry
        want = _np(want)
        np.testing.assert_allclose(_np(got), want, rtol=rtol,
                                   atol=1e-6 * float(np.abs(want).max()))


def _emulate_tc_int8(x, wq, sc, kchunk, fault=None):
    """The bf16 tensor-core W8A16 kernels' order of work on the CPU: each
    64-row k-tile of the weight dequantized on its own (``_dequant``'s
    order, to bf16), its product with x's k-tile summed in fp32 into the
    chunk's accumulator, the K chunks of ``kchunk`` rows (the swap-AB
    kernel's split; all of K for the tiled one) summed in chunk order,
    and one cast to bf16. ``fault``: "skip_tile" drops the second k-tile,
    "neighbour_scale" dequantizes column n with column n ^ 1's scale."""
    k = int(wq.shape[0])
    if fault == "neighbour_scale":
        sc = sc.reshape(-1, 2).flip(1).reshape(-1)
    total = torch.zeros(int(x.shape[0]), int(wq.shape[1]))
    for c0 in range(0, k, kchunk):
        acc = torch.zeros_like(total)
        for k0 in range(c0, min(k, c0 + kchunk), tim.TC_KTILE):
            if fault == "skip_tile" and k0 == tim.TC_KTILE:
                continue
            tile = tim._dequant(wq[k0:k0 + tim.TC_KTILE], sc, torch.bfloat16)
            acc += x[:, k0:k0 + tim.TC_KTILE].float() @ tile.float()
        total += acc
    return total.to(torch.bfloat16)


def _cast_once_ratio(got, want):
    """Largest error over the card's cast-once tolerance: each entry
    within 2^-7 of it plus 1e-5 of the largest entry."""
    want = want.float()
    tol = BF16_ULP * want.abs() + 1e-5 * float(want.abs().max())
    return float(((got.float() - want).abs() / tol).max())


@pytest.mark.parametrize("kernel", ["swap", "tiled"])
@pytest.mark.parametrize("fault", [None, "skip_tile", "neighbour_scale"])
def test_int8_tc_order_of_work_within_tolerance(kernel, fault):
    """The emulated tensor-core kernels lie within the card's cast-once
    tolerance of the plain version (swap-AB: 64 rows over K chunks of 256,
    the last ragged; tiled: one chunk); each seeded fault falls outside
    it, so the tolerance does not hide a wrong kernel."""
    rng = np.random.RandomState(11)
    rows, k, n = (64, 1040, 256) if kernel == "swap" else (130, 1040, 256)
    x = torch.from_numpy(rng.randn(rows, k).astype(np.float32)).to(
        torch.bfloat16)
    wq, sc = tim.quantize_weight(
        torch.from_numpy((0.02 * rng.randn(k, n)).astype(np.float32)))
    kchunk = 256 if kernel == "swap" else k
    ratio = _cast_once_ratio(_emulate_tc_int8(x, wq, sc, kchunk, fault),
                             tim.int8_matmul_reference(x, wq, sc))
    print(f"int8 tc emulation {kernel} fault={fault}: error over "
          f"tolerance {ratio:.4g}")
    if fault is None:
        assert ratio <= 1.0
    else:
        assert ratio > 1.0


# ------------------------------------------------ int8 paged attention
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_int8_paged_attention_plain_matches_jax(dtype, h=4, kvh=2, d=16,
                                                pages=4):
    """GQA (2 kv heads for 4 query heads), as the JAX package's own pin;
    the tiny Llama's streams below cover MHA through the same path."""
    rng = np.random.RandomState(5)
    b, ps = 2, 8
    n = b * pages + 1
    qj, qt = _both(rng.randn(b, 1, h, d), dtype)
    kj, kt = _both(rng.randn(n, ps, kvh, d), dtype)
    vj, vt = _both(rng.randn(n, ps, kvh, d), dtype)
    tbl = (1 + np.arange(b * pages).reshape(b, pages)).astype(np.int32)
    tbl[0, 2:] = 0  # row 0 holds 2 pages; its tail points at page 0
    pos = np.array([13, 8 * pages - 5], np.int32)
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


# query heads, kv heads, head_dim, table width in pages
INT8_PAGED_CASES = {
    "d80": (4, 2, 80, 4),
    "d96": (4, 4, 96, 4),
    "mqa_g16": (16, 1, 16, 4),
    "long": (2, 1, 16, 72),   # a row of more than 64 pages
    # head dims that are not multiples of 16 (the arena stays unpadded)
    "d72": (4, 2, 72, 4),
    "d40": (4, 4, 40, 4),
}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", list(INT8_PAGED_CASES))
def test_int8_paged_attention_plain_matches_jax_shapes(dtype, case):
    """Head dims 80 and 96, MQA with 16 query heads per kv head, and a
    row of 72 pages, as the GQA pin above."""
    test_int8_paged_attention_plain_matches_jax(dtype,
                                                *INT8_PAGED_CASES[case])


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
    """An ``ObservedLayer`` is no longer refused: one around a Linear
    becomes a QuantizedLinear with its calibrated per-channel scales
    (floored at 1e-8, as JAX's), one with a per-tensor scale gets fresh
    per-channel scales, and one around another layer stays as it is."""
    from paddle_tpu_torch.kernels.int8_matmul import quantize_weight
    from paddle_tpu_torch.nn import Linear
    from paddle_tpu_torch.quantization.qat import ObservedLayer

    rng = np.random.RandomState(12)
    lins = [Linear(8, 4, device="cpu") for _ in range(2)]
    for lin in lins:
        with torch.no_grad():
            lin.weight.copy_(torch.from_numpy(
                rng.randn(8, 4).astype(np.float32)))
    scales = (np.abs(rng.randn(4)) * 0.01).astype(np.float32)
    scales[1] = 0.0
    model = torch.nn.Sequential(
        ObservedLayer(lins[0], 0.1, scales),
        ObservedLayer(lins[1], None, 0.02),
        ObservedLayer(torch.nn.ReLU(), 0.1, None))
    out = quantize_for_serving(model)
    assert type(out[0]).__name__ == type(out[1]).__name__ == \
        "QuantizedLinear"
    assert isinstance(out[2], ObservedLayer)
    s = np.maximum(scales, 1e-8)
    want = np.clip(np.round(lins[0].weight.detach().numpy() / s), -127, 127)
    np.testing.assert_array_equal(out[0].weight_q.numpy(), want)
    np.testing.assert_array_equal(out[0].weight_scale.numpy(), s)
    wq, ws = quantize_weight(lins[1].weight.detach())
    assert torch.equal(out[1].weight_q, wq)
    assert torch.equal(out[1].weight_scale, ws)


def test_int8_streams_equal_jax_generate():
    """generate(cache_dtype="int8") and both engines with an int8 cache
    (through their programs and with ``graphs=False``), fp32 weights
    quantized to int8, against JAX ``generate``: two
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
    # each engine through its programs (the default) and eagerly
    engines = [make(graphs=g) for g in (True, False) for make in (
        lambda **kw: ServingEngine(tq, max_batch_size=1, max_seq_len=32,
                                   min_bucket=8, cache_dtype="int8", **kw),
        lambda **kw: PagedServingEngine(tq, max_batch_size=1,
                                        max_seq_len=32, min_bucket=8,
                                        page_size=4, cache_dtype="int8",
                                        **kw))]
    for eng in engines:
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
