"""fp16 serving in the port (paddle_tpu_torch) against the JAX package.

A ``decorate`` O2 fp16 net (every parameter fp16) is served by both
packages' engines over float32, bfloat16 and int8 caches (JAX keeps no
fp16 cache), with float or int8 (``quantize_for_serving``) weights. On
the card that path runs the fp16 kernels this file holds on the CPU:
paged attention with an fp16 q over fp32, bf16 and int8 arenas, the
W8A16 matmul on fp16 x, and (with ``fusions=``) the fused RMSNorm +
matmul head in fp16; the rope-on-load attention in fp16 is the fp16
training step's, held here as a kernel. Each plain version in fp16
(what ``chip_smoke.py`` holds the card's kernels to) is compared with
the JAX function run as the JAX package's own tests run it (Pallas in
interpret mode), on the same seeded numpy inputs. Tolerances:

- the fused RMSNorm + matmul and the W8A16 matmul: cast once to fp16,
  entry by entry within 2^-10 of the entry (one fp16 ulp: both sides sum
  in fp32 and cast once, so the two may round one ulp apart) plus 1e-5
  of the largest entry (the fp32 sums run in other orders), and for the
  head plus what rounding the normed row to fp16 may move an entry by
  where the two rstd differ in the last bit (``normed_rounding_slack``);
- the rope-on-load attention: cast once, as above (everything fp32
  until the one cast, on both sides);
- paged attention: both round the normalised probabilities to fp16,
  where two fp32 softmaxes summed in other orders may round a
  probability one fp16 ulp apart, which moves an output entry by at
  most 2^-11 of sum_c |v_c| p_c <= 2^-11 max|v|; so 2^-10 of the entry
  plus 2^-10 of the largest |v| (int8: of the dequantized values);
- the greedy streams of the decorated net through the port's paged and
  slab engines (``graphs=False``): token for token JAX's paged engine's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.kernels import fused_norm_matmul as jfnm  # noqa: E402
from paddle_tpu.kernels import fused_rope_attention as jfra  # noqa: E402
from paddle_tpu.kernels import int8_matmul as jim  # noqa: E402
from paddle_tpu.kernels import paged_attention as jpa  # noqa: E402
from paddle_tpu.kernels.rope import build_rope_cache  # noqa: E402
from paddle_tpu.quantization import kv as jkv  # noqa: E402
from paddle_tpu.quantization import (  # noqa: E402
    quantize_for_serving as j_quantize,
)
from paddle_tpu.serving import PagedServingEngine as JPaged  # noqa: E402
from paddle_tpu_torch import amp as tamp  # noqa: E402
from paddle_tpu_torch.kernels import fused_norm_matmul as tfnm  # noqa: E402
from paddle_tpu_torch.kernels import fused_rope_attention as tfra  # noqa
from paddle_tpu_torch.kernels import int8_matmul as tim  # noqa: E402
from paddle_tpu_torch.kernels import paged_attention as tpa  # noqa: E402
from paddle_tpu_torch.quantization import kv as tkv  # noqa: E402
from paddle_tpu_torch.quantization import quantize_for_serving  # noqa: E402
from paddle_tpu_torch.serving import (  # noqa: E402
    PagedServingEngine,
    ServingEngine,
)
from test_torch_kernels import _one_thread  # noqa: E402,F401  (autouse)
from test_torch_train import _pair  # noqa: E402

F16_ULP = 2.0 ** -10
TOL32 = 1e-5
JDT = {"float16": jnp.float16, "bfloat16": jnp.bfloat16,
       "float32": jnp.float32}
TDT = {"float16": torch.float16, "bfloat16": torch.bfloat16,
       "float32": torch.float32}


def _both(a, dtype="float16"):
    a = np.asarray(a, np.float32)
    return jnp.asarray(a).astype(JDT[dtype]), \
        torch.from_numpy(a).to(TDT[dtype])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _cast_once_close(got, want, slack=0.0):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    tol = F16_ULP * np.abs(want) + TOL32 * float(np.abs(want).max()) \
        + slack
    assert (np.abs(got - want) <= tol).all(), float(
        (np.abs(got - want) / tol).max())


# --------------------------------------------------------------- kernels
@pytest.mark.parametrize("w_dtype", ["float16", "float32"])
def test_fp16_norm_matmul_plain_matches_jax_kernel(w_dtype):
    """The decorate O2 head: x and the lm_head weight fp16, the norm
    weight fp16 (decorated) or fp32."""
    rng = np.random.RandomState(40)
    jx, tx = _both(rng.randn(2, 8, 64))
    jw, tw = _both(1 + 0.1 * rng.randn(64), w_dtype)
    jm, tm = _both(0.1 * rng.randn(64, 256))
    want = jfnm.rms_norm_matmul(jx, jw, jm, eps=1e-5, block_rows=8,
                                block_cols=128)
    assert want.dtype == jnp.float16
    got = tfnm.rms_norm_matmul(tx, tw, tm, 1e-5)
    assert got.dtype == torch.float16 and tuple(got.shape) == (2, 8, 256)
    _cast_once_close(got, want, _np(tfnm.normed_rounding_slack(
        tx, tw, tm, 1e-5)))


@pytest.mark.parametrize("causal,d,block_q", [(True, 16, 16),
                                               (False, 80, 32)])
def test_fp16_rope_attention_plain_matches_jax_kernel(causal, d, block_q):
    """q, k and v from fp16 projections (the fp16 O1 and O2 steps); head
    dim 80 pairs column c with c + 40, the true half. The causal case
    takes two query blocks of the JAX kernel, the other one."""
    b, s, h = 2, 32, 4
    rng = np.random.RandomState(41 + d)
    (jq, tq), (jk, tk), (jv, tv) = (_both(rng.randn(b, s, h, d))
                                    for _ in range(3))
    cos, sin = build_rope_cache(s, d)
    want = jfra.rope_attention_fused(jq, jk, jv, cos, sin, causal=causal,
                                     block_q=block_q)
    assert want.dtype == jnp.float16
    tcos, tsin = (torch.tensor(np.asarray(t)) for t in (cos, sin))
    got = tfra.rope_attention_fused(tq, tk, tv, tcos, tsin, causal=causal)
    assert got.dtype == torch.float16
    _cast_once_close(got, want)


@pytest.mark.parametrize("arena", ["float32", "bfloat16", "int8"])
def test_fp16_q_paged_attention_plain_matches_jax(arena):
    """An fp16 q (a decorated net's) over the arenas the engines keep:
    fp32, bf16 and int8 (GQA, 2 kv heads for 4 query heads; row 0 holds
    two pages and its tail points at the garbage page 0)."""
    rng = np.random.RandomState(42)
    b, h, kvh, d, ps, pages = 2, 4, 2, 16, 8, 4
    n = b * pages + 1
    qj, qt = _both(rng.randn(b, 1, h, d))
    kv = [_both(rng.randn(n, ps, kvh, d),
                "float32" if arena == "int8" else arena) for _ in range(2)]
    (kj, kt), (vj, vt) = kv
    if arena == "int8":
        kj, vj = (jkv.QuantizedKV(*jkv.quantize_kv(a)) for a in (kj, vj))
        kt, vt = (tkv.QuantizedKV(*tkv.quantize_kv(a)) for a in (kt, vt))
        vmax = float(np.abs(_np(tpa.gather_pages_fp32(
            vt, torch.arange(n)[None]))).max())
    else:
        vmax = float(np.abs(_np(vt)).max())
    tbl = (1 + np.arange(b * pages).reshape(b, pages)).astype(np.int32)
    tbl[0, 2:] = 0
    pos = np.array([13, 8 * pages - 5], np.int32)
    want = jpa.paged_attention_fused(qj, kj, vj, jnp.asarray(tbl),
                                     jnp.asarray(pos))
    assert want.dtype == jnp.float16
    got = tpa.paged_attention(qt, kt, vt, torch.from_numpy(tbl),
                              torch.from_numpy(pos))
    assert got.dtype == torch.float16 and tuple(got.shape) == (b, 1, h, d)
    np.testing.assert_allclose(_np(got), _np(want), rtol=F16_ULP,
                               atol=F16_ULP * vmax)


@pytest.mark.parametrize("rows", [16, 130])
def test_fp16_int8_matmul_plain_matches_jax(rows):
    """fp16 x (a decorate O2 net's quantized projections): the weight
    dequantized to fp16 before the product on both sides; K 1040 is not
    a multiple of the card kernels' 64-row k-tile."""
    rng = np.random.RandomState(43 + rows)
    k, n = 1040, 256
    xj, xt = _both(rng.randn(rows, k))
    w = (0.02 * rng.randn(k, n)).astype(np.float32)
    wqj, scj = jim.quantize_weight(jnp.asarray(w))
    wqt, sct = tim.quantize_weight(torch.from_numpy(w))
    got = tim.int8_matmul(xt, wqt, sct)
    assert got.dtype == torch.float16 and tuple(got.shape) == (rows, n)
    for want in (jim.int8_matmul_composed(xj, wqj, scj),
                 jim.int8_matmul(xj, wqj, scj, block_rows=rows,
                                 block_cols=128)):
        assert want.dtype == jnp.float16
        _cast_once_close(got, want)


# ---------------------------------------------------- the decorated net
PROMPTS = np.random.RandomState(44).randint(0, 96, (2, 6))
NEW = (6, 4)
ENGINE_KW = dict(max_batch_size=2, max_seq_len=16, min_bucket=8)


@pytest.fixture(scope="module")
def fp16_nets():
    """The test-suite's tiny MHA pair (``test_torch_train._pair``), each
    decorated O2 fp16 by its own package, and the same two quantized
    (``quantize_for_serving``) after the decoration."""
    jnet, tnet = _pair("mha", seed=8)
    jnet = paddle.amp.decorate(jnet, level="O2", dtype="float16")
    tnet = tamp.decorate(tnet, level="O2", dtype="float16")
    assert {p.dtype for p in tnet.parameters()} == {torch.float16}
    jnet.eval()
    tnet.eval()
    return {False: (jnet, tnet),
            True: (j_quantize(jnet), quantize_for_serving(tnet))}


def _streams(eng, prompts, news):
    handles = [eng.submit(p, m) for p, m in zip(prompts, news)]
    eng.run_until_idle()
    assert all(h.status == "DONE" for h in handles)
    return [list(np.asarray(h.output_ids)) for h in handles]


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("cache", ["float32", "bfloat16", "int8"])
def test_decorated_fp16_streams_equal_jax_engine(fp16_nets, cache, quant):
    """Two requests (the second shorter) through JAX's paged engine and
    the port's paged and slab engines, eagerly: the same tokens."""
    jnet, tnet = fp16_nets[quant]
    want = _streams(JPaged(jnet, page_size=4, cache_dtype=cache,
                           **ENGINE_KW), PROMPTS, NEW)
    for eng in (PagedServingEngine(tnet, page_size=4, cache_dtype=cache,
                                   graphs=False, **ENGINE_KW),
                ServingEngine(tnet, cache_dtype=cache, graphs=False,
                              **ENGINE_KW)):
        assert _streams(eng, PROMPTS, NEW) == want, type(eng).__name__
