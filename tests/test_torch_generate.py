"""``generate`` as one program per signature (``paddle_tpu_torch/models/
generation.py``) on the CPU, where the program's body runs as a plain
call over its static inputs:

the program equals ``graphs=False`` token for token for greedy, sampled,
beam and EOS freezing; ``graphs=False``'s sampled stream equals a loop
that samples each step with the serving engines' ``_select_next``; the
cache keys equal JAX's ``sig`` (``paddle_tpu/models/generation.py:456-
466``, beam normalizing the sampling knobs out); one capture per
signature; an in-place weight update shows in the next call without a
capture, and a replaced parameter or a change of ``net.fusions`` captures
again; greedy fp32 equals JAX ``generate``. The card's programs (CUDA
graphs) are held against the eager loop by ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.core.tensor import Tensor  # noqa: E402
from paddle_tpu.models import LlamaConfig as JConfig  # noqa: E402
from paddle_tpu.models import LlamaForCausalLM as JLlama  # noqa: E402
from paddle_tpu_torch.convert import load_numpy_state  # noqa: E402
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM  # noqa
from paddle_tpu_torch.models import generation as gen  # noqa: E402
from paddle_tpu_torch.serving.sampling_keys import (  # noqa: E402
    SamplingKeySource,
)
from test_torch_kernels import _one_thread  # noqa: E402,F401  (autouse)

CFG = dict(vocab_size=96, hidden_size=32, intermediate_size=64,
           num_hidden_layers=2, num_attention_heads=4,
           max_position_embeddings=64)
IDS = np.random.RandomState(0).randint(0, 96, (2, 7))
NEW = 9
CASES = {
    "greedy": dict(),
    "sampled": dict(do_sample=True, temperature=0.8, top_p=0.9, seed=7),
    "sampled_top_k_eos": dict(do_sample=True, top_k=5, eos_token_id=3,
                              seed=2),
    "beam": dict(num_beams=3),
    "greedy_eos": dict(eos_token_id=None),   # the EOS is found below
    "beam_eos": dict(num_beams=3, eos_token_id=None),
}


@pytest.fixture(scope="module")
def pair():
    paddle.seed(4)
    jnet = JLlama(JConfig(**CFG))
    jnet.eval()
    tnet = LlamaForCausalLM(LlamaConfig(**CFG), device="cpu")
    load_numpy_state(tnet, {k: np.asarray(p.value)
                            for k, p in jnet.named_parameters()})
    return jnet, tnet


def _kw(net, case):
    kw = dict(CASES[case], max_new_tokens=NEW, cache_dtype="float32")
    if "eos_token_id" in kw and kw["eos_token_id"] is None:
        # the greedy or beam winner's third token: a row that emits it
        # freezes there
        first = net.generate(IDS, **dict(kw, eos_token_id=None),
                             graphs=False)
        kw["eos_token_id"] = int(first[0, IDS.shape[1] + 2])
    return kw


@pytest.mark.parametrize("case", sorted(CASES))
def test_program_equals_eager_loop(pair, case):
    tnet = pair[1]
    kw = _kw(tnet, case)
    want = tnet.generate(IDS, graphs=False, **kw)
    for _ in range(2):  # the capturing call, then a replay
        got = tnet.generate(IDS, **kw)
        assert torch.equal(got, want), case
    eos = kw.get("eos_token_id")
    if eos is not None:
        for row in want[:, IDS.shape[1]:].tolist():
            if eos in row:
                assert set(row[row.index(eos):]) == {eos}


def test_eager_sampling_equals_select_next_loop(pair):
    """``graphs=False``'s sampled stream equals a loop that samples each
    step with ``_select_next`` (the engines' sampler) from the same
    position-addressed keys."""
    tnet = pair[1]
    kw = CASES["sampled"]
    got = tnet.generate(IDS, max_new_tokens=NEW, cache_dtype="float32",
                        graphs=False, **kw)
    src = SamplingKeySource(kw["seed"])
    keys = [src.next_request_key() for _ in range(IDS.shape[0])]
    S = IDS.shape[1]
    ids = torch.from_numpy(IDS)
    with torch.inference_mode():
        caches = gen.alloc_kv_caches(tnet.config, 2, S + NEW, "float32",
                                     device="cpu")
        logits, caches = gen.prefill(tnet, ids, caches)
        toks = []
        for i in range(NEW):
            if i:
                logits, caches = gen.decode_step(
                    tnet, toks[-1][:, None], caches, S + i - 1)
            toks.append(gen._select_next(
                logits, True, kw["temperature"], 0, kw["top_p"],
                [(k, S + i) for k in keys]))
    assert torch.equal(got[:, S:], torch.stack(toks, dim=1))


def test_cache_keys_are_jax_sig_and_greedy_equals_jax(pair):
    """Greedy fp32 equals JAX ``generate``; the program caches of both
    packages hold the same keys after the same calls (beam normalizes
    the sampling knobs out)."""
    jnet, _ = pair
    tnet = LlamaForCausalLM(LlamaConfig(**CFG), device="cpu")
    load_numpy_state(tnet, {k: np.asarray(p.value)
                            for k, p in jnet.named_parameters()})
    calls = [dict(max_new_tokens=NEW, cache_dtype="float32"),
             dict(max_new_tokens=2, num_beams=2, top_k=3, top_p=0.5,
                  temperature=0.7, cache_dtype="float32")]
    want = np.asarray(jnet.generate(Tensor(jnp.asarray(IDS)),
                                    **calls[0]).numpy())
    jnet.generate(Tensor(jnp.asarray(IDS[:, :3])), **calls[1])
    got = tnet.generate(IDS, **calls[0])
    tnet.generate(IDS[:, :3], **calls[1])
    np.testing.assert_array_equal(got.numpy(), want)
    assert list(tnet._generate_cache) == list(jnet._generate_cache)


def test_one_capture_per_signature_and_weights_by_address(pair):
    tnet = LlamaForCausalLM(LlamaConfig(**CFG), device="cpu")
    load_numpy_state(tnet, {k: p.detach().numpy()
                            for k, p in pair[1].named_parameters()})
    cache = gen.generate_programs(tnet)
    kw = dict(max_new_tokens=NEW, cache_dtype="float32")
    a = tnet.generate(IDS, **kw)
    tnet.generate(IDS, **kw)
    tnet.generate(IDS[:1], **kw)          # another signature
    assert cache.captures == 2 and len(cache) == 2
    # an in-place update (an optimizer step, a reload's copy) shows in
    # the next call, with no capture
    with torch.no_grad():
        tnet.lm_head.weight.mul_(-1.0)
    b = tnet.generate(IDS, **kw)
    assert cache.captures == 2
    assert torch.equal(b, tnet.generate(IDS, graphs=False, **kw))
    assert not torch.equal(a, b)
    # a replaced parameter is another address: captured again
    tnet.lm_head.weight = torch.nn.Parameter(
        tnet.lm_head.weight.detach().clone() * -1.0)
    c = tnet.generate(IDS, **kw)
    assert cache.captures == 3 and torch.equal(c, a)
    # so is a change of fusions (the forward the program runs)
    tnet.fusions = {"rms_norm_matmul"}
    tnet.generate(IDS, **kw)
    assert cache.captures == 4
    # a copy of the net starts with an empty cache
    import copy

    assert len(gen.generate_programs(copy.deepcopy(tnet))) == 0
