"""The paged engine's prefix cache in the port
(``paddle_tpu_torch/serving/prefix_cache.py``, ``paged_pool.py``,
``paged_engine.py``) against the JAX package's, on the CPU.

A tiny fp32 Llama with the JAX model's weights: the pool's refcounts and
the store's chain walk, publish, eviction and flush equal JAX's on one
script of calls; the chunk plan and tail ladder equal JAX's over a grid;
the gather plus chunk prefill equals JAX ``prefill(pos=c)`` and the
port's own full prefill; warm streams (full-page hits, a copy-on-write
clone, second turns over decode-published pages) equal JAX ``generate``
in fp32 and the port's cold engine in bf16 and int8; decode-published KV
equals one prefill of the same tokens (the JAX pin
``tests/test_prefix_cache.py:345-406``, rebuilt within the port); shared
pages are never written; demand growth, the ``pages_exhausted`` shed,
the eviction gate and the drain; and ``warmup()``'s gather and chunk
inventory. The ``cuda``-marked card tests are in
``tests/test_torch_cuda.py``.
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
from paddle_tpu.models.generation import alloc_kv_caches as j_alloc  # noqa
from paddle_tpu.models.generation import prefill as j_prefill  # noqa: E402
from paddle_tpu.observability.registry import MetricsRegistry  # noqa: E402
from paddle_tpu.serving import PagedKVPool as JPool  # noqa: E402
from paddle_tpu.serving import PagedServingEngine as JPaged  # noqa: E402
from paddle_tpu.serving import PrefixCache as JPrefixCache  # noqa: E402
from paddle_tpu_torch.convert import load_numpy_state  # noqa: E402
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM  # noqa
from paddle_tpu_torch.models.generation import alloc_kv_caches  # noqa: E402
from paddle_tpu_torch.quantization import kv as tkv  # noqa: E402
from paddle_tpu_torch.serving import (  # noqa: E402
    REASON_PAGES_EXHAUSTED,
    PagedKVPool,
    PagedServingEngine,
    PrefixCache,
    RemotePrefillClient,
)
from test_torch_kernels import _one_thread  # noqa: E402,F401  (autouse)

CFG = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
           num_hidden_layers=2, num_attention_heads=4)
# the warm engines' geometry: 2 rows of 64 slots, pages of 8
GEOM = dict(max_batch_size=2, max_seq_len=64, min_bucket=8, page_size=8)
PS = 8
# fp32 logits and KV of the port against the JAX model (the model
# tests' bound for fp32 math in other orders)
ATOL, RTOL = 2e-5, 1e-4


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
def jax_prefill(nets):
    """The JAX model's weights and one jitted ``prefill(pos=...)`` (one
    trace a shape, shared by the cases)."""
    jnet, _ = nets
    params = {k: p.value for k, p in jnet.named_parameters()}
    buffers = {k: b.value for k, b in jnet.named_buffers()}

    def body(pp, bb, x, n, pos, caches):
        jnet.load_functional_state(pp, bb)
        jnet.eval()
        return j_prefill(jnet, x, caches, length=n, pos=pos)

    return params, buffers, jax.jit(body)


def _leaves(caches):
    out = []
    for k, v in caches:
        for x in (k, v):
            out += [x.q, x.scale] if tkv.is_quantized(x) else [x]
    return out


def _drained(eng):
    """Zero leaked pages and no reference left after ``close()``."""
    st = eng.page_pool.stats()
    assert st["pages_in_use"] == 0, st
    assert st["claims"] == st["releases"], st
    assert eng.page_pool._refs == {}


def _warm(tnet, dtype="float32", **kw):
    return PagedServingEngine(tnet, cache_dtype=dtype, prefix_cache=True,
                              **{**GEOM, **kw})


# ------------------------------------------------------------ host state
def test_pool_and_store_equal_jax_on_one_script(nets):
    """(a) One script of claim, incref, release, publish,
    publish_partial, match, evict and flush calls on the port's pool and
    store and on JAX's (a private registry): equal page ids, covered
    spans, eviction order and stats at every step."""
    jnet, tnet = nets
    mk = dict(page_size=4, num_pages=12, max_seq_len=48)
    jp = JPool(jnet.config, dtype="bfloat16", **mk)
    tp = PagedKVPool(tnet.config, dtype="bfloat16", device="cpu", **mk)
    jc = JPrefixCache(jp, registry=MetricsRegistry())
    tc = PrefixCache(tp)
    a = list(range(10))              # two full pages and a 2-token tail
    b = list(range(8)) + [40, 41, 42, 43, 44]
    c = [50, 51, 52, 53, 54, 55]

    def both(fn):
        out = [fn(p, s) for p, s in ((jp, jc), (tp, tc))]
        assert out[0] == out[1], out
        assert jp.stats() == tp.stats()
        js, ts = jc.stats(), tc.stats()
        assert js == ts, (js, ts)
        return out[1]

    def match(toks, n):
        return lambda p, s: (lambda m: (m.pages, m.covered))(
            s.match(toks, n, "v0"))

    pa = both(lambda p, s: p.claim(3))
    both(lambda p, s: s.publish(a, 10, pa, "v0"))
    both(lambda p, s: s.publish_partial(a, 10, pa[2], "v0"))
    pb = both(lambda p, s: p.claim(4))
    assert both(match(b, 13)) == (pa[:2], 8)
    both(lambda p, s: p.incref(pa[:2]))        # b adopts a's two pages
    both(lambda p, s: s.publish(b, 13, pa[:2] + pb, "v0"))
    # a's two pages: owner, cache and b (one saved copy each); a's tail
    # page and b's third page: owner and cache
    assert both(lambda p, s: (p.shared_pages, p.shared_saved_pages)) \
        == (4, 2)
    pc = both(lambda p, s: p.claim(2))
    both(lambda p, s: s.publish(c, 6, pc, "v0"))
    assert both(match(a, 10)) == (pa, 10)      # the partial tail hits
    assert both(match(a[:9], 9)) == (pa, 9)
    assert both(lambda p, s: s.evictable_pages()) == 0
    both(lambda p, s: p.release(pa))           # a finishes
    both(lambda p, s: p.release(pa[:2] + pb))  # b finishes
    both(lambda p, s: p.release(pc))           # c finishes
    # a's pages (two full, one partial), b's third and c's first
    assert both(lambda p, s: s.evictable_pages()) == 5
    # a page left out pins itself, not its descendants
    assert both(lambda p, s: s.evictable_pages(exclude=pa[:1])) == 4
    both(match(c, 6))                          # c is the newest hit
    order = []
    for _ in range(5):
        both(lambda p, s: s.evict(1))
        order.append(both(lambda p, s: sorted(
            e.page for e in s._entries.values())))
    assert order[-1] == []
    both(lambda p, s: p.claim(5))
    both(lambda p, s: s.flush())
    free = next(i for i in range(1, 13) if tp.refcount(i) == 0)
    with pytest.raises(ValueError, match="not claimed"):
        tp.release([free])
    with pytest.raises(ValueError, match="not claimed"):
        tp.incref([free])


def test_chunk_plan_and_tail_ladder_equal_jax(nets):
    """(b) ``_chunk_plan`` and ``_tail_buckets`` against the JAX
    engine's over (prompt length, covered, bucket)."""
    jnet, tnet = nets
    geom = dict(max_batch_size=2, max_seq_len=128, min_bucket=8,
                page_size=8)
    jeng = JPaged(jnet, cache_dtype="float32", prefix_cache=True, **geom)
    teng = _warm(tnet, **geom)
    for bucket in (8, 16, 32, 64, 128):
        assert teng._tail_buckets(bucket) == jeng._tail_buckets(bucket)
    for prompt_len in range(2, 121):
        bucket = teng.pool.bucket_for(prompt_len)
        assert bucket == jeng.pool.bucket_for(prompt_len)
        for covered in range(1, prompt_len + 1):
            assert (teng._chunk_plan(prompt_len, bucket, covered)
                    == jeng._chunk_plan(prompt_len, bucket, covered)), (
                prompt_len, covered)
    teng.close()


# ---------------------------------------------------------- device pieces
@pytest.mark.parametrize("c,tb", [(16, 16), (23, 8)])
def test_gather_and_chunk_equal_jax_and_full_prefill(nets, jax_prefill, c,
                                                     tb):
    """(c) A 28-token prompt: the port's full prefill adopted into arena
    pages, gathered back into a block and chunk-prefilled from ``c``
    gives the full prefill's logits row and block KV bit for bit, and
    JAX ``prefill(pos=c)`` over the JAX block's first ``c`` slots
    within the fp32 bound. ``c`` is a ``[1]`` tensor: the same chunk
    body serves every start."""
    jnet, tnet = nets
    rng = np.random.RandomState(11)
    ids = rng.randint(0, 64, (28,))
    cfg = tnet.config
    full = torch.zeros((1, 32), dtype=torch.long)
    full[0, :28] = torch.from_numpy(ids)
    tail = torch.zeros((1, tb), dtype=torch.long)
    tail[0, :28 - c] = torch.from_numpy(ids[c:])
    with torch.inference_mode():
        ref = alloc_kv_caches(cfg, 1, 32, "float32", device="cpu")
        want = tnet(full, caches=ref, pos=0)[0][0, 27]
        arena = PagedKVPool(cfg, page_size=PS, num_pages=6,
                            dtype="float32", device="cpu")
        arena = arena.alloc_arena_arrays()
        pages = torch.tensor([3, 1, 5, 2])
        for a, r in zip(_leaves(arena), _leaves(ref)):
            tkv.adopt_into_pages(a, r, pages, 4, PS)
        blk = alloc_kv_caches(cfg, 1, 32, "float32", device="cpu")
        src = torch.zeros(4, dtype=torch.long)
        n_gather = -(-c // PS)
        src[:n_gather] = pages[:n_gather]
        for a, b in zip(_leaves(arena), _leaves(blk)):
            tkv.gather_block_from_pages(a, src, 4, PS, b)
        got = tnet(tail, caches=blk,
                   pos=torch.tensor([c], dtype=torch.int32))[0][0, 27 - c]
    assert torch.equal(got, want)
    for b, r in zip(_leaves(blk), _leaves(ref)):
        assert torch.equal(b[:, :28], r[:, :28])
    # the JAX reference: prefill(pos=c) over a block whose [0, c) came
    # from a JAX full prefill (tests/test_prefix_cache.py:186-256)
    params, buffers, fn = jax_prefill
    try:
        _, jfull = fn(params, buffers,
                      jnp.asarray(full.numpy().astype(np.int32)),
                      jnp.int32(28), jnp.int32(0),
                      j_alloc(jnet.config, 1, 32, "float32"))
        jblk = [(k.at[:, c:].set(0), v.at[:, c:].set(0)) for k, v in jfull]
        jl, jc = fn(params, buffers,
                    jnp.asarray(tail.numpy().astype(np.int32)),
                    jnp.int32(28 - c), jnp.int32(c), jblk)
    finally:
        jnet.load_functional_state(params, buffers)
        jnet.eval()
    np.testing.assert_allclose(got.numpy(), np.asarray(jl)[0], atol=ATOL,
                               rtol=RTOL)
    for b, jleaf in zip(_leaves(blk), [x for kv in jc for x in kv]):
        np.testing.assert_allclose(b[:, :28].numpy(),
                                   np.asarray(jleaf)[:, :28], atol=ATOL,
                                   rtol=RTOL)


# ------------------------------------------------------------ the streams
def _traffic(eng, rng):
    """Two requests over a 20-token prefix, then (after they finish and
    publish) three warm ones: another tail, the first 16 prefix tokens
    (a page-aligned prompt) and the first 19 (its boundary falls inside
    a cached page: a clone), then a second turn over the first request's
    answer. Returns the handles."""
    prefix = rng.randint(0, 64, (20,))
    first = [np.concatenate([prefix, rng.randint(0, 64, (4,))])
             for _ in range(2)]
    hs = [eng.submit(p, 6) for p in first]
    eng.run_until_idle()
    hs += [eng.submit(p, 6) for p in (
        np.concatenate([prefix, rng.randint(0, 64, (4,))]), prefix[:16],
        prefix[:19])]
    eng.run_until_idle()
    hs.append(eng.submit(np.concatenate(
        [hs[0].output_ids, rng.randint(0, 64, (3,))]), 5))
    eng.run_until_idle()
    assert all(h.status == "DONE" for h in hs)
    return hs


def test_warm_streams_equal_jax_generate_fp32(nets):
    """(d) fp32 warm streams, first turns, a clone and a second turn
    over decode-published pages, == JAX ``generate`` token for token."""
    jnet, tnet = nets
    eng = _warm(tnet)
    hs = _traffic(eng, np.random.RandomState(3))
    st = eng.prefix_cache.stats()
    assert st["hits"] == 5 and st["misses"] == 1
    assert st["cow_clones"] >= 1
    assert eng.chunk_prefills == 5 and eng.local_prefills == 1
    assert eng.metrics.warm_prefill_time.count == 5
    for h in hs:
        want = np.asarray(jnet.generate(
            Tensor(jnp.asarray(h.request.input_ids[None])),
            max_new_tokens=h.request.max_new_tokens,
            cache_dtype="float32").numpy())[0]
        np.testing.assert_array_equal(h.output_ids, want)
    eng.close()
    _drained(eng)


@pytest.mark.parametrize("dtype,sample", [("bfloat16", False),
                                          ("int8", False),
                                          ("float32", True)])
def test_warm_streams_equal_cold_engine(nets, dtype, sample):
    """(d) bf16 and int8 arenas: the same traffic's warm streams == a
    cold engine's (no cache, pages up front); the quantized case also
    with int8 weights. Sampled (fp32): the chunk prefill samples its
    first token at the cold path's key address, ``c + length``."""
    _, tnet = nets
    net = tnet
    if dtype == "int8":
        from paddle_tpu_torch.quantization import quantize_for_serving

        net = quantize_for_serving(tnet)
    kw = (dict(do_sample=True, temperature=0.8, top_k=20, seed=7)
          if sample else {})
    warm = _warm(net, dtype, **kw)
    cold = PagedServingEngine(net, cache_dtype=dtype, **GEOM, **kw)
    hw = _traffic(warm, np.random.RandomState(4))
    hc = _traffic(cold, np.random.RandomState(4))
    for a, b in zip(hw, hc):
        np.testing.assert_array_equal(a.output_ids, b.output_ids)
    assert warm.prefix_cache.stats()["hits"] == 5
    for eng in (warm, cold):
        eng.close()
        _drained(eng)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "float32"])
def test_decode_published_kv_equals_prefill(nets, dtype):
    """(e) The pages a finished request publishes, its prompt from the
    prefill and its answer from the decode steps, hold the KV one
    prefill of the same tokens writes: bit for bit in bf16 and int8 (the
    JAX pin); fp32 within 1e-6 (the decode step's products run at
    another row count)."""
    _, tnet = nets
    eng = _warm(tnet, dtype)
    prompt = np.random.RandomState(6).randint(0, 64, (16,))
    h = eng.submit(prompt, 8)
    eng.run_until_idle()
    full = [int(t) for t in prompt] + h.tokens
    valid = 16 + len(h.tokens) - 1
    m = eng.prefix_cache.match(full, valid, eng.weights_version)
    assert m.covered == valid
    ref = alloc_kv_caches(tnet.config, 1, 32, dtype, device="cpu")
    ids = torch.zeros((1, 32), dtype=torch.long)
    ids[0, :valid] = torch.tensor(full[:valid])
    with torch.inference_mode():
        tnet(ids, caches=ref, pos=0)
    for i, page in enumerate(m.pages):
        rows = min(PS, valid - i * PS)
        for a, r in zip(_leaves(eng._caches), _leaves(ref)):
            got, want = a[page][:rows], r[0][i * PS:i * PS + rows]
            if dtype == "float32":
                assert float((got - want).abs().max()) <= 1e-6
            else:
                assert torch.equal(got, want), (dtype, i)
    eng.close()
    _drained(eng)


def test_shared_pages_never_written(nets):
    """(f) A warm admission's adopt sends every shared page's block
    index to the garbage page 0, and the bytes of every cached page are
    unchanged after warm admissions that reference it, a clone
    included."""
    _, tnet = nets
    eng = _warm(tnet, "bfloat16")
    prefix = np.random.RandomState(8).randint(0, 64, (20,))
    eng.submit(prefix, 4)
    eng.run_until_idle()
    cached = sorted(e.page for e in eng.prefix_cache._entries.values())
    before = [a[cached].clone() for a in _leaves(eng._caches)]
    adopted = []
    run_adopt = eng._run_adopt
    eng._run_adopt = lambda blk, ids: (adopted.append(ids.copy()),
                                       run_adopt(blk, ids))
    hs = [eng.submit(p, 5) for p in (
        np.concatenate([prefix[:16], [1, 2, 3]]), prefix[:19], prefix)]
    eng.run_until_idle()
    assert all(h.status == "DONE" for h in hs)
    assert eng.prefix_cache.cow_clones.value >= 1
    for ids in adopted:
        assert not set(ids.tolist()) & set(cached), ids
    for a, b in zip(_leaves(eng._caches), before):
        assert torch.equal(a[cached], b)
    eng.close()
    _drained(eng)


# ------------------------------------------ demand growth, eviction, drain
def test_demand_growth_one_page_per_boundary_and_shed(nets):
    """(g) Admission claims the prompt's page only and each crossed
    boundary one more (3 pages written of a 25-token span); on a small
    arena a growth that cannot be met sheds that request with
    ``pages_exhausted``, its tokens kept, the other unharmed."""
    _, tnet = nets
    eng = _warm(tnet, max_batch_size=1)
    h = eng.submit(np.arange(8) % 64, 17)
    eng.step()
    assert eng.page_pool.claims == 2 and len(eng._row_pages[0]) == 2
    eng.run_until_idle()
    assert h.status == "DONE" and eng.page_pool.claims == 3
    eng.close()
    _drained(eng)
    eng = _warm(tnet, num_pages=5, max_prefills_per_step=None)
    rng = np.random.RandomState(9)
    ha, hb = (eng.submit(rng.randint(0, 64, (10,)), 30) for _ in range(2))
    eng.run_until_idle()
    assert sorted([ha.status, hb.status]) == ["CANCELLED", "DONE"]
    shed, winner = (ha, hb) if ha.status == "CANCELLED" else (hb, ha)
    assert shed.reason == REASON_PAGES_EXHAUSTED and shed.tokens
    assert len(winner.tokens) == 30
    assert eng.metrics.sheds.by_label() == {REASON_PAGES_EXHAUSTED: 1}
    eng.close()
    _drained(eng)


def test_warm_head_waits_for_pages_not_its_own(nets):
    """(h) The fits gate leaves out the pages the head would adopt: with
    only those evictable it waits, queued, and admits once a row frees
    pages; its stream still equals the cold path's."""
    _, tnet = nets
    eng = _warm(tnet, num_pages=4)
    rng = np.random.RandomState(10)
    prefix = rng.randint(0, 64, (16,))
    eng.submit(prefix, 1)
    eng.run_until_idle()
    assert eng.prefix_cache.cached_pages == 2
    hb = eng.submit(rng.randint(0, 64, (10,)), 5)
    eng.step()
    assert hb.status == "RUNNING" and eng.page_pool.free_pages == 0
    hc = eng.submit(np.concatenate([prefix, rng.randint(0, 64, (2,))]), 3)
    eng.step()
    assert hc.status == "QUEUED"
    eng.run_until_idle()
    assert hb.status == "DONE" and hc.status == "DONE"
    want = tnet.generate(hc.request.input_ids[None], max_new_tokens=3,
                         cache_dtype="float32")[0].numpy()
    np.testing.assert_array_equal(hc.output_ids, want)
    eng.close()
    _drained(eng)


def test_mixed_churn_leaves_no_page_or_reference(nets):
    """(i) Finishes, a deadline, clones, evictions and a close with
    requests in flight over one shared arena: zero pages in use, claims
    == releases, no reference left."""
    _, tnet = nets
    t = [0.0]
    eng = _warm(tnet, num_pages=10, clock=lambda: t[0])
    rng = np.random.RandomState(12)
    prefix = rng.randint(0, 64, (16,))
    eng.submit(np.concatenate([prefix, rng.randint(0, 64, (3,))]), 2)
    eng.run_until_idle()
    eng.submit(np.concatenate([prefix, rng.randint(0, 64, (4,))]), 24)
    dead = eng.submit(np.concatenate([prefix, rng.randint(0, 64, (5,))]), 4,
                      deadline_s=5.0)
    eng.step()
    t[0] = 10.0
    eng.step()
    assert dead.status in ("TIMEOUT", "DONE")
    for _ in range(3):
        eng.submit(rng.randint(0, 64, (18,)), 3)
        for _ in range(12):
            if eng.scheduler.depth or eng.active_slots:
                eng.step()
    assert eng.prefix_cache.evictions.value > 0
    eng.close()
    _drained(eng)


def test_failed_warm_admission_raises_and_releases(nets):
    """A chunk prefill that fails raises out of ``step()`` (the request
    rejected with ``admission_error``), never falls back to the cold
    prefill, and gives back what the admission took: its row, its fresh
    pages and its references to the shared ones."""
    _, tnet = nets
    eng = _warm(tnet)
    prefix = np.random.RandomState(14).randint(0, 64, (16,))
    eng.submit(prefix, 2)
    eng.run_until_idle()
    refs = dict(eng.page_pool._refs)
    local = eng.local_prefills

    def broken(blk):
        def body(ids, pos):
            raise RuntimeError("chunk failed")
        return body

    eng._chunk_body = broken
    h = eng.submit(np.concatenate([prefix, [5, 6]]), 3)
    with pytest.raises(RuntimeError, match="chunk failed"):
        eng.step()
    assert h.status == "REJECTED" and h.reason.startswith("admission_error")
    assert eng.local_prefills == local and eng.free_rows == 2
    assert eng.page_pool._refs == refs
    eng.close()
    _drained(eng)


def test_warmup_captures_gather_and_chunk_inventory(nets):
    """(j) ``warmup()`` adds a gather per bucket and a chunk per (bucket,
    tail bucket) to the base inventory (JAX's ladder: 4 + 10 at buckets
    8-64), once; traffic captures nothing after it, and graphs=True and
    graphs=False run the same streams."""
    _, tnet = nets
    eng = _warm(tnet)
    nb = len(eng._warmup_buckets())
    assert nb == 4
    assert eng.warmup()["programs"] == 1 + 2 * nb + nb + nb * (nb + 1) // 2
    counts = eng.compile_counts()
    assert counts == {"serving::decode_step": 1, "serving::prefill": nb,
                      "serving::adopt": nb, "serving::gather_pages": nb,
                      "serving::chunk_prefill": nb * (nb + 1) // 2}
    assert eng.warmup()["programs"] == 0
    eager = _warm(tnet, graphs=False)
    assert eager.warmup()["programs"] == 0
    hg = _traffic(eng, np.random.RandomState(13))
    he = _traffic(eager, np.random.RandomState(13))
    for a, b in zip(hg, he):
        np.testing.assert_array_equal(a.output_ids, b.output_ids)
    assert eng.compile_counts() == counts
    # remote prefill (queue A item 1.7) is ported: an engine holding a
    # transport captures the same inventory (its local-fallback programs)
    held = _warm(tnet, prefill_transport=RemotePrefillClient("127.0.0.1", 1))
    held.warmup()
    assert held.compile_counts() == counts
    held.close()
    for e in (eng, eager):
        e.close()
        _drained(e)
