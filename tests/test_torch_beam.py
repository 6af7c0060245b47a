"""Beam search in the port's ``generate`` (``paddle_tpu_torch/models/
generation.py`` ``beam_search``) against the JAX package's
``_beam_decode_ids`` on the CPU: a one-layer tiny Llama with the same
weights, fp32 caches, equal tokens for B 2 with an EOS (whose freeze also
holds) and for B 1 (each batch row's beams are their own, so row 0 of the
JAX run is the B 1 reference: one JAX compile);
the sampling refusal; and the top-k tie rule (the lower index first, as
``jax.lax.top_k``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.core.tensor import Tensor  # noqa: E402
from paddle_tpu.models import LlamaConfig as JConfig  # noqa: E402
from paddle_tpu.models import LlamaForCausalLM as JLlama  # noqa: E402
from paddle_tpu_torch.convert import load_numpy_state  # noqa: E402
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM  # noqa
from paddle_tpu_torch.models.generation import top_k_stable  # noqa: E402
from test_torch_kernels import _one_thread  # noqa: E402,F401  (autouse)

CFG = dict(vocab_size=97, hidden_size=32, intermediate_size=64,
           num_hidden_layers=1, num_attention_heads=2)


@pytest.fixture(scope="module")
def nets():
    paddle.seed(5)
    jnet = JLlama(JConfig.tiny(**CFG))
    jnet.eval()
    tnet = LlamaForCausalLM(LlamaConfig.tiny(**CFG), device="cpu")
    load_numpy_state(tnet, {k: np.asarray(p.value)
                            for k, p in jnet.named_parameters()})
    return jnet, tnet


def _jax(jnet, ids, **kw):
    out = jnet.generate(Tensor(jnp.asarray(ids, jnp.int32)), **kw)
    return np.asarray(out.numpy())


def test_beam_search_equals_jax(nets):
    """``generate(num_beams=3)`` == JAX's, fp32 caches, token for token,
    at B 2 and B 1; an EOS (the winning beam's third token in a run
    without one) freezes the beams that emit it: after it, the winner
    emits only EOS."""
    jnet, tnet = nets
    ids = np.random.RandomState(2).randint(1, 97, (2, 7))
    kw = dict(max_new_tokens=8, num_beams=3, cache_dtype="float32")
    free = tnet.generate(ids, **kw).numpy()
    eos = int(free[0, 7 + 2])
    kw["eos_token_id"] = eos
    want = _jax(jnet, ids, **kw)
    got = tnet.generate(ids, **kw).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tnet.generate(ids[:1], **kw).numpy(),
                                  want[:1])
    row = list(got[0, 7:])
    at = row.index(eos)
    assert at <= 2 and set(row[at:]) == {eos}
    assert not np.array_equal(got, free)


def test_beam_search_refuses_sampling(nets):
    _, tnet = nets
    with pytest.raises(ValueError, match="beam search"):
        tnet.generate(np.ones((1, 4), np.int64), max_new_tokens=2,
                      num_beams=2, do_sample=True)


def test_top_k_keeps_the_lower_index_on_a_tie():
    """The beam's selection over ``[B, k * V]`` and the first expansion:
    ties resolved as ``jax.lax.top_k`` does (lower index first)."""
    x = np.random.RandomState(0).randint(0, 4, (3, 40)).astype(np.float32)
    x[1] = 1.0  # all tied
    vals, idx = top_k_stable(torch.from_numpy(x), 6)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 6)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
