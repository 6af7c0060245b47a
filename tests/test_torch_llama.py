"""The port's Llama (paddle_tpu_torch.models) against the JAX package's,
with the JAX net's weights carried across by paddle_tpu_torch.convert.

Tiny configs, fp32 on the CPU: an MHA variant and a GQA variant (2 kv
heads for 4 query heads). Logits are held to 2e-5 absolute / 1e-4
relative: the same fp32 math, reduced in other orders by XLA and by
PyTorch's CPU kernels, through two layers.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.core.tensor import Tensor  # noqa: E402
from paddle_tpu.models import LlamaConfig as JConfig  # noqa: E402
from paddle_tpu.models import LlamaForCausalLM as JLlama  # noqa: E402
from paddle_tpu.models import generation as jgen  # noqa: E402
from paddle_tpu_torch.convert import (  # noqa: E402
    load_numpy_state,
    state_dict_from_numpy,
)
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM  # noqa: E402
from paddle_tpu_torch.models import generation as tgen  # noqa: E402
from test_torch_kernels import _one_thread  # noqa: E402,F401  (autouse)

ATOL, RTOL = 2e-5, 1e-4
CFG = dict(vocab_size=96, hidden_size=32, intermediate_size=64,
           num_hidden_layers=2, num_attention_heads=4,
           max_position_embeddings=64)
VARIANTS = {"mha": None, "gqa": 2}


def _pair(variant):
    kw = dict(CFG, num_key_value_heads=VARIANTS[variant])
    paddle.seed(11)
    jnet = JLlama(JConfig(**kw))
    jnet.eval()
    arrays = {k: np.asarray(p.value) for k, p in jnet.named_parameters()}
    tnet = LlamaForCausalLM(LlamaConfig(**kw), device="cpu", seed=1)
    load_numpy_state(tnet, arrays)
    return jnet, tnet


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def nets(request):
    return _pair(request.param)


def _close(got, want):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               atol=ATOL, rtol=RTOL)


def _ids(b, s, seed):
    return np.random.RandomState(seed).randint(0, CFG["vocab_size"],
                                               (b, s)).astype(np.int32)


def test_convert_names_and_shapes(nets):
    jnet, tnet = nets
    j = {k: tuple(p.shape) for k, p in jnet.named_parameters()}
    t = {k: tuple(p.shape) for k, p in tnet.named_parameters()}
    assert j == t
    arrays = {k: np.asarray(p.value) for k, p in jnet.named_parameters()}
    sd = state_dict_from_numpy(arrays, tnet.config, "cpu", torch.float32)
    assert set(sd) == set(t) and all(v.dtype == torch.float32
                                     for v in sd.values())
    bad = dict(arrays)
    bad.pop("lm_head.weight")
    with pytest.raises(KeyError, match="lm_head"):
        load_numpy_state(tnet, bad)
    bad = dict(arrays, **{"lm_head.weight": arrays["lm_head.weight"].T})
    with pytest.raises(ValueError, match="lm_head"):
        load_numpy_state(tnet, bad)


def test_cache_free_logits_match(nets):
    jnet, tnet = nets
    ids = _ids(2, 7, 0)
    want = np.asarray(jnet(Tensor(jnp.asarray(ids))).value)
    with torch.inference_mode():
        got = tnet(torch.from_numpy(ids).long())
    assert tuple(got.shape) == (2, 7, CFG["vocab_size"])
    _close(got, want)


def test_prefill_and_decode_slab_logits_match(nets):
    """Whole-batch prefill, then decode steps at a scalar position and
    at per-row positions (the continuous-batching form)."""
    jnet, tnet = nets
    cfg = tnet.config
    ids = _ids(2, 6, 1)
    jc = jgen.alloc_kv_caches(jnet.config, 2, 16, "float32")
    tc = tgen.alloc_kv_caches(cfg, 2, 16, "float32", device="cpu")
    jl, jc = jgen.prefill(jnet, jnp.asarray(ids), jc)
    tl, tc = tgen.prefill(tnet, torch.from_numpy(ids).long(), tc)
    _close(tl, jl)
    tok = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
    jl, jc = jgen.decode_step(jnet, jnp.asarray(tok), jc, jnp.int32(6))
    tl, tc = tgen.decode_step(tnet, torch.from_numpy(tok).long(), tc, 6)
    _close(tl, jl)
    # per-row depths: row 0 re-decodes position 7, row 1 position 5
    pos = np.array([7, 5], np.int32)
    jl, jc = jgen.decode_step(jnet, jnp.asarray(tok), jc, jnp.asarray(pos))
    tl, tc = tgen.decode_step(tnet, torch.from_numpy(tok).long(), tc,
                              torch.from_numpy(pos))
    _close(tl, jl)
    for (jk, jv), (tk, tv) in zip(jc, tc):
        _close(tk, jk)
        _close(tv, jv)


def test_paged_decode_logits_match(nets):
    """One paged decode step over the same page arenas and table: the
    JAX model's composed gather path against the port's paged attention
    (its plain version on the CPU). Row 1 is a free row on the garbage
    page 0, as in the engines."""
    jnet, tnet = nets
    cfg = tnet.config
    rng = np.random.RandomState(2)
    ps, width, n_pages = 4, 3, 7
    shape = (n_pages, ps, cfg.kv_heads, cfg.head_dim)
    arenas = [(rng.randn(*shape).astype(np.float32),
               rng.randn(*shape).astype(np.float32))
              for _ in range(cfg.num_hidden_layers)]
    tbl = np.array([[3, 1, 5], [0, 0, 0], [2, 6, 0]], np.int32)
    pos = np.array([9, 0, 6], np.int32)
    tok = _ids(3, 1, 3)
    jc = [(jnp.asarray(k), jnp.asarray(v)) for k, v in arenas]
    tc = [(torch.from_numpy(k.copy()), torch.from_numpy(v.copy()))
          for k, v in arenas]
    jl, jc = jgen.decode_step(jnet, jnp.asarray(tok), jc, jnp.asarray(pos),
                              page_table=jnp.asarray(tbl))
    tl, tc = tgen.decode_step(tnet, torch.from_numpy(tok).long(), tc,
                              torch.from_numpy(pos),
                              page_table=torch.from_numpy(tbl))
    _close(tl[[0, 2]], np.asarray(jl)[[0, 2]])
    for (jk, jv), (tk, tv) in zip(jc, tc):
        _close(tk[1:], np.asarray(jk)[1:])  # page 0 is garbage
        _close(tv[1:], np.asarray(jv)[1:])


def test_generate_greedy_matches(nets):
    jnet, tnet = nets
    ids = _ids(2, 5, 4)
    want = np.asarray(jnet.generate(Tensor(jnp.asarray(ids)),
                                    max_new_tokens=6,
                                    cache_dtype="float32").numpy())
    got = tnet.generate(ids, max_new_tokens=6, cache_dtype="float32")
    np.testing.assert_array_equal(got.numpy(), want)


def test_exit_layer_and_final_norm_seams(nets):
    jnet, tnet = nets
    ids = _ids(1, 4, 5)
    want = np.asarray(jnet.model(Tensor(jnp.asarray(ids)),
                                 apply_final_norm=False,
                                 exit_layer=1).value)
    with torch.inference_mode():
        got = tnet.model(torch.from_numpy(ids).long(),
                         apply_final_norm=False, exit_layer=1)
    _close(got, want)
