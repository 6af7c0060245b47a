"""The serving engines' fixed-shape programs (``paddle_tpu_torch/serving/
programs.py``) on the CPU, where each program's body runs as a plain
call over its static inputs (a card captures and replays it; the
``cuda``-marked tests in ``tests/test_torch_cuda.py`` hold a replay
bit-equal to the eager step there).

A tiny fp32 Llama of the port, greedy and sampled, on the slab and paged
engines: the programs' streams equal the eager engine's
(``graphs=False``) and ``generate``; a change of ``net.fusions`` on a
live engine captures the model programs again; the launch counters
take a capture's launches off and add them at each replay; the tensor
form of ``adopt_into_slab`` is bit-equal to the int form; a bucket's
block is unique. The streams against JAX ``generate`` and ``warmup()``'s
inventory against the JAX engine's are in ``tests/test_torch_serving.py``
and ``tests/test_torch_quant.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu_torch import kernels  # noqa: E402
from paddle_tpu_torch.kernels import int8_matmul, rms_norm  # noqa: E402
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM  # noqa
from paddle_tpu_torch.quantization import kv as tkv  # noqa: E402
from paddle_tpu_torch.serving import (  # noqa: E402
    KVCachePool,
    PagedServingEngine,
    ServingEngine,
)
from test_torch_kernels import _one_thread  # noqa: E402,F401  (autouse)

CFG = LlamaConfig.tiny(vocab_size=64, hidden_size=32, intermediate_size=64,
                       num_hidden_layers=2, num_attention_heads=4)
RNG = np.random.RandomState(21)
PROMPTS = [RNG.randint(0, 64, (n,)) for n in (6, 11, 3, 9)]
NEWS = [5, 3, 7, 4]
ENGINES = {
    "slab": lambda net, **kw: ServingEngine(
        net, max_batch_size=2, max_seq_len=32, min_bucket=8,
        cache_dtype="float32", **kw),
    "paged": lambda net, **kw: PagedServingEngine(
        net, max_batch_size=2, max_seq_len=32, min_bucket=8, page_size=4,
        cache_dtype="float32", **kw),
}


@pytest.fixture(scope="module")
def net():
    return LlamaForCausalLM(CFG, device="cpu", seed=3)


def _streams(eng, prompts=PROMPTS, news=NEWS):
    handles = [eng.submit(p, m) for p, m in zip(prompts, news)]
    eng.run_until_idle()
    assert all(h.status == "DONE" for h in handles)
    return [list(h.output_ids) for h in handles]


def test_measure_launches_adds_per_replay():
    """What a body adds to the counters is taken off after it (a capture
    launches nothing) and added at each replay, design counters too."""
    kernels.reset_launch_counts()
    rms_norm.launches = 5

    def body():
        rms_norm.launches += 2
        int8_matmul.launches += 1
        int8_matmul.tc_launches += 1
        return "out"

    out, launches = kernels.measure_launches(body)
    assert out == "out"
    assert rms_norm.launches == 5 and int8_matmul.launches == 0
    assert sorted((m.__name__.rsplit(".", 1)[1], a, n)
                  for m, a, n in launches) == [
        ("int8_matmul", "launches", 1), ("int8_matmul", "tc_launches", 1),
        ("rms_norm", "launches", 2)]
    for _ in range(3):
        kernels.add_launches(launches)
    counts = kernels.launch_counts()
    assert counts["rms_norm"] == 11 and counts["int8_matmul"] == 3
    assert kernels.int8_matmul_design_counts() == {"tc_launches": 3,
                                                   "cc_launches": 0}
    kernels.reset_launch_counts()
    assert not any(kernels.launch_counts().values())


@pytest.mark.parametrize("cache", ["float32", "int8"])
def test_adopt_into_slab_tensor_index_equals_int(cache):
    shape = (3, 16, 2, 8)
    rng = np.random.RandomState(0)
    blk_f = torch.from_numpy(rng.randn(1, 8, 2, 8).astype(np.float32))
    if cache == "int8":
        def make():
            return tkv.QuantizedKV(*tkv.quantize_kv(torch.from_numpy(
                np.random.RandomState(1).randn(*shape).astype(np.float32))))
        blk = tkv.QuantizedKV(*tkv.quantize_kv(blk_f))
    else:
        def make():
            return torch.from_numpy(
                np.random.RandomState(1).randn(*shape).astype(np.float32))
        blk = blk_f
    a, b = make(), make()
    tkv.adopt_into_slab(a, blk, 2)
    tkv.adopt_into_slab(b, blk, torch.tensor([2]))
    for x, y in ((a.q, b.q), (a.scale, b.scale)) if cache == "int8" \
            else ((a, b),):
        assert torch.equal(x, y)


def test_pool_holds_one_block_per_bucket():
    pool = KVCachePool(CFG, dtype="float32", min_bucket=8, max_seq_len=32,
                       device="cpu")
    blk = pool.alloc(5)
    with pytest.raises(RuntimeError, match="bucket 8 is live"):
        pool.alloc(7)
    other = pool.alloc(12)  # another bucket
    pool.free(blk)
    assert pool.alloc(3) is blk
    assert other.bucket == 16


@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_programs_equal_eager_engine_and_generate(net, kind):
    graphs = ENGINES[kind](net)
    eager = ENGINES[kind](net, graphs=False)
    got = _streams(graphs)
    assert got == _streams(eager)
    for p, m, s in zip(PROMPTS, NEWS, got):
        want = net.generate(p[None], max_new_tokens=m,
                            cache_dtype="float32")[0].tolist()
        assert s == want
    counts = graphs.compile_counts()
    assert counts["serving::decode_step"] == 1
    assert counts["serving::prefill"] == counts["serving::adopt"] == 2
    assert eager.compile_counts() == dict.fromkeys(counts, 0)
    assert eager.warmup() == {"programs": 0, "aot_hits": 0, "aot_saves": 0}


@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_fusions_change_captures_again(kind):
    """A live engine whose net selects both fusions serves the fused
    streams: its model programs are captured again (counted), its adopt
    programs kept."""
    net = LlamaForCausalLM(CFG, device="cpu", seed=3)
    eng = ENGINES[kind](net)
    eng.warmup()
    before = eng.compile_counts()
    assert before == {"serving::decode_step": 1, "serving::prefill": 3,
                      "serving::adopt": 3}
    plain = _streams(eng)
    assert eng.compile_counts() == before
    net.fusions = ("rms_norm_matmul", "rope_attention")
    try:
        fused = _streams(eng)
        want = [net.generate(p[None], max_new_tokens=m,
                             cache_dtype="float32")[0].tolist()
                for p, m in zip(PROMPTS, NEWS)]
        eager = _streams(ENGINES[kind](net, graphs=False))
    finally:
        net.fusions = ()
    assert fused == want == eager
    assert plain == [net.generate(p[None], max_new_tokens=m,
                                  cache_dtype="float32")[0].tolist()
                     for p, m in zip(PROMPTS, NEWS)]
    assert eng.compile_counts() == dict(
        before, **{"serving::decode_step": 2, "serving::prefill": 5})


def test_sampled_streams_equal_with_and_without_programs(net):
    kw = dict(do_sample=True, temperature=0.8, top_k=8, seed=11)
    for kind in sorted(ENGINES):
        assert _streams(ENGINES[kind](net, **kw)) == _streams(
            ENGINES[kind](net, graphs=False, **kw))
