"""The port's serving slice end to end: its slab and paged engines
against the JAX package's ``LlamaForCausalLM.generate`` on the same
weights (the reference's own pin, tests/test_serving.py).

A tiny fp32 Llama on the CPU, 2 rows, 4 staggered requests: late
requests take rows freed by early completions, and every greedy stream
(fp32 KV cache) is token-for-token equal to JAX's ``generate`` with an
fp32 cache, through the engines' fixed-shape programs (the default) and
eagerly (``graphs=False``, the ``*_eager`` cases). ``warmup()``
captures the JAX engine's inventory (one decode step, a prefill and an
adopt per bucket of ``_warmup_buckets``), and traffic after it captures
nothing. No row or page leaks.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.core.tensor import Tensor  # noqa: E402
from paddle_tpu.models import LlamaConfig as JConfig  # noqa: E402
from paddle_tpu.models import LlamaForCausalLM as JLlama  # noqa: E402
from paddle_tpu.serving import PagedServingEngine as JPaged  # noqa: E402
from paddle_tpu.serving import ServingEngine as JEngine  # noqa: E402
from paddle_tpu_torch.convert import load_numpy_state  # noqa: E402
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM  # noqa: E402
from paddle_tpu_torch.serving import (  # noqa: E402
    REASON_TOO_LONG,
    PagedServingEngine,
    ServingEngine,
)
from test_torch_kernels import _one_thread  # noqa: E402,F401  (autouse)

CFG = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
           num_hidden_layers=2, num_attention_heads=4)
RNG = np.random.RandomState(7)
PROMPTS = [RNG.randint(0, 64, (1, n)).astype(np.int32) for n in (6, 5, 7, 9)]
MAX_NEWS = [3, 9, 6, 8]  # staggered completion frees rows early


@pytest.fixture(scope="module")
def nets():
    paddle.seed(5)
    jnet = JLlama(JConfig.tiny(**CFG))
    jnet.eval()
    tnet = LlamaForCausalLM(LlamaConfig.tiny(**CFG), device="cpu")
    load_numpy_state(tnet, {k: np.asarray(p.value)
                            for k, p in jnet.named_parameters()})
    return jnet, tnet


@pytest.fixture(scope="module")
def jax_streams(nets):
    """JAX ``generate`` (fp32 cache) per request: the reference."""
    jnet, _ = nets
    return [
        np.asarray(jnet.generate(Tensor(jnp.asarray(p)), max_new_tokens=m,
                                 cache_dtype="float32").numpy())[0]
        for p, m in zip(PROMPTS, MAX_NEWS)
    ]


ENGINES = {
    "slab": lambda net, **kw: ServingEngine(
        net, max_batch_size=2, max_seq_len=64, min_bucket=8,
        cache_dtype="float32", **kw),
    "paged": lambda net, **kw: PagedServingEngine(
        net, max_batch_size=2, max_seq_len=64, min_bucket=8, page_size=4,
        cache_dtype="float32", **kw),
}
# the same engines stepping eagerly (the programs' reference)
ENGINES.update({f"{k}_eager": (lambda make: lambda net, **kw: make(
    net, graphs=False, **kw))(make) for k, make in list(ENGINES.items())})


@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_engine_streams_equal_jax_generate(nets, jax_streams, kind):
    _, tnet = nets
    eng = ENGINES[kind](tnet)
    handles = [eng.submit(p, m) for p, m in zip(PROMPTS, MAX_NEWS)]
    eng.run_until_idle()
    for h, want in zip(handles, jax_streams):
        assert h.status == "DONE"
        np.testing.assert_array_equal(h.output_ids, want)
    # continuous batching happened: the last two requests were admitted
    # only once a row freed, while another request was still decoding
    steps = [h.admitted_step for h in handles]
    assert steps[2] > 0 and steps[3] > steps[2]
    assert steps[2] < handles[1].finished_step
    assert eng.metrics.completed.value == 4
    assert eng.metrics.tokens_out.value == sum(MAX_NEWS)
    assert eng.metrics.ttft.count == 4 and eng.metrics.itl.count > 0
    assert eng.active_slots == 0 and eng.pool.occupancy == 0
    if kind.startswith("paged"):
        assert eng.page_pool.pages_in_use == 0
        assert eng.page_pool.claims == eng.page_pool.releases > 0
        assert not eng._tables.any()


def test_port_generate_equals_jax_generate(nets, jax_streams):
    _, tnet = nets
    for p, m, want in zip(PROMPTS, MAX_NEWS, jax_streams):
        got = tnet.generate(p, max_new_tokens=m, cache_dtype="float32")
        np.testing.assert_array_equal(got[0].numpy(), want)


def test_paged_engine_caps_prefills_per_step(nets):
    _, tnet = nets
    eng = ENGINES["paged"](tnet)
    handles = [eng.submit(p, 4) for p in PROMPTS[:2]]
    eng.step()
    assert [h.status for h in handles] == ["RUNNING", "QUEUED"]
    eng.run_until_idle()
    assert handles[1].admitted_step == 1


@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_engine_rejects_too_long(nets, kind):
    _, tnet = nets
    eng = ENGINES[kind](tnet)
    h = eng.submit(RNG.randint(0, 64, (1, 60)), 8)  # 68 > 64
    assert h.status == "REJECTED" and h.reason == REASON_TOO_LONG
    assert eng.metrics.rejected.by_label() == {REASON_TOO_LONG: 1}


def test_sampled_streams_reproducible_across_batch_and_backend(nets):
    """A sampled token is a function of (seed, admission index,
    position): the same seed and workload give the same streams on the
    slab and paged engines and at another batch size."""
    _, tnet = nets

    def run(kind, rows, seed=11):
        kw = dict(max_batch_size=rows, max_seq_len=64, min_bucket=8,
                  cache_dtype="float32", do_sample=True, temperature=0.8,
                  top_k=8, seed=seed)
        eng = (ServingEngine(tnet, **kw) if kind == "slab"
               else PagedServingEngine(tnet, page_size=4, **kw))
        return [h.tokens for h in eng.generate(PROMPTS, 5)]

    first = run("paged", 2)
    assert run("paged", 2) == first
    assert run("slab", 2) == first
    assert run("paged", 1) == first
    assert run("paged", 2, seed=12) != first


def test_small_arena_admits_by_free_pages(nets):
    """An arena of 6 usable 4-slot pages holds one 20-token request at a
    time: the second waits for the first's pages (strict FIFO), and the
    streams are unchanged."""
    _, tnet = nets
    eng = PagedServingEngine(tnet, max_batch_size=2, max_seq_len=64,
                             min_bucket=8, page_size=4, num_pages=6,
                             cache_dtype="float32")
    a, b = (eng.submit(p[:, :5], 15) for p in PROMPTS[:2])
    eng.step()
    eng.step()
    assert a.status == "RUNNING" and b.status == "QUEUED"
    assert eng.page_pool.free_pages == 1
    eng.run_until_idle()
    assert b.admitted_step >= a.finished_step
    for h, p in ((a, PROMPTS[0]), (b, PROMPTS[1])):
        want = tnet.generate(p[:, :5], max_new_tokens=15,
                             cache_dtype="float32")[0].numpy()
        np.testing.assert_array_equal(h.output_ids, want)
    assert eng.page_pool.pages_in_use == 0


def test_deadline_expires_queued_and_running(nets):
    """Clock injection: a queued request past its deadline never runs;
    a running one frees its row mid-decode, keeping partial tokens."""
    _, tnet = nets
    t = [0.0]
    eng = PagedServingEngine(tnet, max_batch_size=1, max_seq_len=64,
                             min_bucket=8, page_size=4,
                             cache_dtype="float32", clock=lambda: t[0])
    run = eng.submit(PROMPTS[0], 20, deadline_s=5.0)
    queued = eng.submit(PROMPTS[1], 4, deadline_s=1.0)
    eng.step()
    assert run.status == "RUNNING" and len(run.tokens) == 2
    t[0] = 6.0
    eng.run_until_idle()
    assert queued.status == "TIMEOUT" and queued.tokens == []
    assert run.status == "TIMEOUT" and len(run.tokens) == 2
    assert eng.metrics.timeouts.value == 2
    assert eng.page_pool.pages_in_use == 0 and eng.free_rows == 1


def test_paged_engine_close_releases_everything(nets):
    _, tnet = nets
    eng = ENGINES["paged"](tnet)
    handles = [eng.submit(p, 8) for p in PROMPTS]
    eng.step()
    eng.close()
    assert all(h.status == "CANCELLED" for h in handles)
    assert eng.page_pool.pages_in_use == 0 and eng.free_rows == 2


def test_paged_engine_at_head_dim_72_equals_jax_generate():
    """A tiny fp32 GQA Llama at head dim 72 (not a multiple of 16: the
    card pads it): the paged engine's greedy streams equal JAX
    ``generate`` token for token."""
    cfg = dict(CFG, hidden_size=288, num_key_value_heads=2,
               num_hidden_layers=1)
    paddle.seed(6)
    jnet = JLlama(JConfig.tiny(**cfg))
    jnet.eval()
    tnet = LlamaForCausalLM(LlamaConfig.tiny(**cfg), device="cpu")
    load_numpy_state(tnet, {k: np.asarray(p.value)
                            for k, p in jnet.named_parameters()})
    assert tnet.config.hidden_size // tnet.config.num_attention_heads == 72
    eng = ENGINES["paged"](tnet)
    handles = [eng.submit(p, m) for p, m in zip(PROMPTS[:2], (5, 4))]
    eng.run_until_idle()
    for h, p, m in zip(handles, PROMPTS, (5, 4)):
        want = np.asarray(jnet.generate(
            Tensor(jnp.asarray(p)), max_new_tokens=m,
            cache_dtype="float32").numpy())[0]
        assert h.status == "DONE"
        np.testing.assert_array_equal(h.output_ids, want)


@pytest.mark.parametrize("kind", ["paged", "slab"])
def test_warmup_captures_the_jax_inventory(nets, jax_streams, kind):
    """``warmup()`` captures one decode step and a prefill and an adopt
    per bucket of the JAX engine's ladder for the same geometry (the JAX
    engine is built, not warmed: nothing compiles), once; traffic after
    it captures nothing (the pin of tests/test_prefix_cache.py), and the
    streams still equal JAX ``generate``."""
    jnet, tnet = nets
    jeng = (JPaged(jnet, max_batch_size=2, max_seq_len=64, min_bucket=8,
                   page_size=4, cache_dtype="float32") if kind == "paged"
            else JEngine(jnet, max_batch_size=2, max_seq_len=64,
                         min_bucket=8, cache_dtype="float32"))
    buckets = jeng._warmup_buckets()
    assert buckets == [8, 16, 32, 64]
    eng = ENGINES[kind](tnet)
    assert eng.warmup() == {"programs": 1 + 2 * len(buckets),
                            "aot_hits": 0, "aot_saves": 0}
    counts = eng.compile_counts()
    assert counts == {"serving::decode_step": 1,
                      "serving::prefill": len(buckets),
                      "serving::adopt": len(buckets)}
    assert eng.warmup()["programs"] == 0
    with pytest.raises(NotImplementedError, match="queue A item 7"):
        eng.warmup(aot_cache="unused")
    handles = [eng.submit(p, m) for p, m in zip(PROMPTS, MAX_NEWS)]
    eng.run_until_idle()
    for h, want in zip(handles, jax_streams):
        np.testing.assert_array_equal(h.output_ids, want)
    assert eng.compile_counts() == counts
