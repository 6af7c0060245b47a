"""Speculative decoding in the port (``paddle_tpu_torch/serving/
speculative.py`` and the engines' seams) against the JAX package's, on
the CPU, with the JAX tests' tiny nets (``tests/test_speculative.py``)
and their weights carried across.

The acceptance math against JAX's (probabilities within 1e-6, equal
outcomes); one verify program's rows and written block against JAX's
``build_verify_body`` (jitted) on the same block (parallel over fp32,
sequential over int8); greedy speculative streams in fp32 equal
JAX ``generate`` (slab and paged, early exit and a separate draft); in
bf16 and int8 equal the port's vanilla engine, and the verify rows of a
bf16 net equal its vanilla decode rows bit for bit (the JAX exactness
pin, rebuilt within the port); full acceptance at the last layer; the
chi-square pin of ``accept_sampled`` over the port's keys; sampled
streams equal on slab and paged; zero leaked pages after rollbacks and
shared prefix pages unchanged; ``bind``'s validations; and ``warmup()``'s
inventory, with graph and eager streams equal. The ``cuda``-marked card
tests are in ``tests/test_torch_cuda.py``.
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
from paddle_tpu.quantization.kv import QuantizedKV as JQuantizedKV  # noqa
from paddle_tpu.serving import speculative as jspec  # noqa: E402
from paddle_tpu_torch.convert import load_numpy_state  # noqa: E402
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM  # noqa
from paddle_tpu_torch.models.generation import alloc_kv_caches  # noqa: E402
from paddle_tpu_torch.models.generation import decode_step  # noqa: E402
from paddle_tpu_torch.quantization import kv as tkv  # noqa: E402
from paddle_tpu_torch.serving import (  # noqa: E402
    ACCEPT,
    DRAFT,
    RESIDUAL,
    PagedServingEngine,
    ServingEngine,
    SpeculativeDecoder,
    purpose_key,
)
from paddle_tpu_torch.serving import speculative as tspec  # noqa: E402
from paddle_tpu_torch.serving.sampling_keys import uniform  # noqa: E402
from test_torch_kernels import _one_thread  # noqa: E402,F401  (autouse)

TARGET = dict(vocab_size=97, hidden_size=64, intermediate_size=128,
              num_hidden_layers=3, num_attention_heads=4)
DRAFT_CFG = dict(vocab_size=97, hidden_size=32, intermediate_size=64,
                 num_hidden_layers=1, num_attention_heads=2)
MAX_NEW = 8
# fp32 logits and KV of the port against the JAX model (the model
# tests' bound for fp32 math in other orders)
ATOL, RTOL = 2e-5, 1e-4
SLAB = dict(max_batch_size=4, max_seq_len=64, min_bucket=8)
PAGED = dict(max_batch_size=4, max_seq_len=64, min_bucket=8, page_size=8,
             demand_paging=True)


def _carry(seed, cfg):
    paddle.seed(seed)
    jnet = JLlama(JConfig.tiny(**cfg))
    jnet.eval()
    tnet = LlamaForCausalLM(LlamaConfig.tiny(**cfg), device="cpu")
    load_numpy_state(tnet, {k: np.asarray(p.value)
                            for k, p in jnet.named_parameters()})
    return jnet, tnet


@pytest.fixture(scope="module")
def nets():
    return _carry(5, TARGET)


@pytest.fixture(scope="module")
def draft_net():
    return _carry(6, DRAFT_CFG)[1]


@pytest.fixture(scope="module")
def prompts():
    """Two prompts of 7 tokens: their rounds cross the 8 and 16 buckets,
    and one JAX ``generate`` call (one compile) gives both references."""
    return list(np.random.RandomState(17).randint(1, 97, (2, 7)))


@pytest.fixture(scope="module")
def jax_streams(nets, prompts):
    """JAX ``generate`` with an fp32 cache: the reference streams."""
    jnet, _ = nets
    out = np.asarray(jnet.generate(
        Tensor(jnp.asarray(np.stack(prompts))), max_new_tokens=MAX_NEW,
        cache_dtype="float32").numpy())
    return [list(row[7:]) for row in out]


def _engine(kind, net, dtype, **kw):
    if kind == "slab":
        return ServingEngine(net, cache_dtype=dtype, **SLAB, **kw)
    return PagedServingEngine(net, cache_dtype=dtype, **PAGED, **kw)


def _streams(eng, prompts, close=True):
    hs = eng.generate(prompts, max_new_tokens=MAX_NEW)
    assert all(h.status == "DONE" for h in hs), [
        (h.status, h.reason) for h in hs]
    if close:
        eng.close()
    return [list(h.tokens) for h in hs]


_VANILLA = {}


def _vanilla(net, prompts, dtype):
    """The port's vanilla (slab) greedy streams per cache dtype."""
    if dtype not in _VANILLA:
        _VANILLA[dtype] = _streams(_engine("slab", net, dtype), prompts)
    return _VANILLA[dtype]


def _drained(eng):
    st = eng.page_pool.stats()
    assert st["pages_in_use"] == 0, st
    assert st["claims"] == st["releases"], st


# ---------------------------------------------------------- acceptance
@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, 0, 1.0), (0.7, 5, 1.0), (0.9, 20, 0.95)])
def test_dist_and_accept_greedy_equal_jax(temperature, top_k, top_p):
    """(a) ``_dist`` within 1e-6 of JAX's (same support) and
    ``accept_greedy`` with JAX's outcomes on seeded rows."""
    rng = np.random.RandomState(11)
    rows = (rng.randn(4, 97) * 3).astype(np.float32)
    for row in rows:
        got = tspec._dist(row, temperature, top_k, top_p)
        want = jspec._dist(row, temperature, top_k, top_p)
        np.testing.assert_array_equal(got > 0, want > 0)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    top = rows.argmax(1)
    for props in (list(top[:3]), list(top[:2]) + [int(top[2] + 1) % 97],
                  [],
                  [int(top[0] + 1) % 97]):
        assert tspec.accept_greedy(rows, props) == \
            jspec.accept_greedy(rows, props)


_CHI2_CRIT = {1: 10.83, 2: 13.82, 3: 16.27, 4: 18.47, 5: 20.52,
              6: 22.46, 7: 24.32, 8: 26.12, 9: 27.88, 10: 29.59}


def test_rejection_sampling_chi_square():
    """(f) The Leviathan/Chen pin of ``tests/test_speculative.py:176-224``
    over the port's keys: over 1000 request keys the first token
    ``accept_sampled`` emits follows the filtered target distribution
    (chi-square at p = 0.001, fixed keys, so the pass is reproducible),
    both branches run, nothing outside the support appears; and the
    three purposes draw distinct uniforms, none the position key's."""
    T, TK, TP, POS, N = 0.8, 5, 0.9, 0, 1000
    rng = np.random.RandomState(0)
    p_logits = rng.randn(11).astype(np.float32) * 2.0
    q_logits = rng.randn(11).astype(np.float32) * 2.0
    bonus = rng.randn(11).astype(np.float32)
    q = tspec._dist(q_logits, T, TK, TP)
    expected = tspec._dist(p_logits, T, TK, TP)
    counts = np.zeros(11, np.int64)
    accepts = 0
    for t in range(N):
        rk = (123, t)
        d = tspec._sample(q, purpose_key(rk, POS + 1, DRAFT))
        a, emitted = tspec.accept_sampled(
            np.stack([p_logits, bonus]), q_logits[None, :], [d], rk, POS,
            T, TK, TP)
        counts[emitted[0]] += 1
        accepts += a
    assert 0 < accepts < N
    assert counts[expected == 0].sum() == 0
    exp = expected * N
    keep = exp >= 5
    obs_k, exp_k = counts[keep].astype(float), exp[keep]
    if (~keep).any() and exp[~keep].sum() > 0:
        obs_k = np.append(obs_k, counts[~keep].sum())
        exp_k = np.append(exp_k, exp[~keep].sum())
    chi2 = float(((obs_k - exp_k) ** 2 / exp_k).sum())
    df = len(exp_k) - 1
    assert df >= 1
    assert chi2 < _CHI2_CRIT[min(df, 10)], (chi2, df)
    from paddle_tpu_torch.serving.sampling_keys import position_key
    rk = (3, 0)
    us = {uniform(purpose_key(rk, 4, p)) for p in (DRAFT, ACCEPT, RESIDUAL)}
    us.add(uniform(position_key(rk, 4)))
    assert len(us) == 4


# ------------------------------------------------------------ the verify
def _blocks(rng, cfg, width, dtype):
    """The same random block content for JAX (flat list) and the port."""
    shape = (1, width, cfg.kv_heads, cfg.head_dim)
    jflat, tblock = [], []
    for _ in range(cfg.num_hidden_layers):
        pair = []
        for _ in range(2):
            if dtype == "int8":
                q = rng.randint(-127, 128, shape).astype(np.int8)
                sc = (rng.rand(*shape[:-1]) * 0.02).astype(np.float32)
                jflat.append(JQuantizedKV(jnp.asarray(q), jnp.asarray(sc)))
                pair.append(tkv.QuantizedKV(torch.from_numpy(q.copy()),
                                            torch.from_numpy(sc.copy())))
            else:
                a = rng.randn(*shape).astype(np.float32)
                jflat.append(jnp.asarray(a))
                pair.append(torch.from_numpy(a.copy()))
        tblock.append(tuple(pair))
    return jflat, tblock


def _leaves(x):
    if isinstance(x, (JQuantizedKV, tkv.QuantizedKV)):
        return [np.asarray(x.q), np.asarray(x.scale)]
    return [np.asarray(x)]


def _paged_verify(tnet, dtype, tblock, ids, pos):
    """The paged engine's verify over an arena whose row 0 holds
    ``tblock`` (width 32, pages of 8): its logits, and the arena read back
    as a ``[1, 32]`` block per layer."""
    eng = PagedServingEngine(tnet, cache_dtype=dtype, max_batch_size=4,
                             max_seq_len=32, min_bucket=8, page_size=8)
    pages = eng.page_pool.claim(4)
    eng._tables[0, :4] = pages
    idx = torch.as_tensor(pages)
    with torch.inference_mode():
        for arena, blk in zip(eng._caches, tblock):
            for a, b in zip(arena, blk):
                for x, y in zip(_leaves_t(a), _leaves_t(b)):
                    x[idx] = y[0].reshape((4, 8) + tuple(y.shape[2:]))
        logits = eng._spec_verify(0, ids, pos)
        back = [tuple(tkv.QuantizedKV(a.q[idx].reshape((1, 32)
                                                       + a.q.shape[2:]),
                                      a.scale[idx].reshape(
                                          (1, 32) + a.scale.shape[2:]))
                      if tkv.is_quantized(a) else
                      a[idx].reshape((1, 32) + a.shape[2:]) for a in pair)
                for pair in eng._caches]
    eng.close()
    return logits, back


def _leaves_t(x):
    return [x.q, x.scale] if tkv.is_quantized(x) else [x]


@pytest.mark.parametrize("dtype,sequential,kind", [
    pytest.param("float32", False, "slab", id="float32-False"),
    pytest.param("int8", True, "slab", id="int8-True"),
    pytest.param("float32", False, "paged", id="float32-paged"),
    pytest.param("int8", True, "paged", id="int8-paged")])
def test_verify_program_equals_jax_body(nets, dtype, sequential, kind):
    """(b) One verify over a block (width 32, k1 3 at pos 9) and JAX
    ``build_verify_body`` on the same block, outside any engine (one
    ``jax.jit`` of the body: op-by-op JAX takes seconds here): the slab's
    verify body over the block, and the paged engine's verify (decode
    replays over an arena holding the block in its row's pages); logits
    and the written block within 2e-5 + 1e-4 relative (int8: codes
    within one step, scales within the tolerance; a code can land on the
    other side of a rounding midpoint)."""
    jnet, tnet = nets
    cfg = tnet.config
    rng = np.random.RandomState(4)
    jflat, tblock = _blocks(rng, cfg, 32, dtype)
    ids = rng.randint(1, 97, (1, 3))
    params = {k: p.value for k, p in jnet.named_parameters()}
    buffers = {k: b.value for k, b in jnet.named_buffers()}
    jbody = jax.jit(jspec.build_verify_body(jnet, 3, sequential))
    try:
        jlogits, jblock = jbody(params, buffers,
                                jnp.asarray(ids, jnp.int32), jflat,
                                jnp.int32(9))
    finally:
        # the trace swapped tracers into the net's layers: put its
        # concrete state back (the JAX engine's restore discipline)
        jnet.load_functional_state(params, buffers)
        jnet.eval()
    if kind == "slab":
        body = tspec.build_verify_body(tnet, tblock, 3, sequential)
        with torch.inference_mode():
            logits = body(torch.as_tensor(ids),
                          torch.tensor([9], dtype=torch.int32))
    else:
        logits, tblock = _paged_verify(tnet, dtype, tblock, ids, 9)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=ATOL, rtol=RTOL)
    got = [x for pair in tblock for t in pair for x in _leaves(t)]
    want = [x for t in jblock for x in _leaves(t)]
    for g, w in zip(got, want):
        if g.dtype == np.int8:
            assert np.abs(g.astype(int) - w.astype(int)).max() <= 1
        else:
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL)


def test_verify_rows_equal_vanilla_rows_bf16():
    """The exactness the port rebuilds within itself (``ROADMAP.md``
    queue C): a bf16 net's verify rows (chunk of 5 over a gathered block,
    k1 rows) equal its vanilla slab decode rows (8 rows, one token a
    step) at the same positions bit for bit on the CPU; fp32 within
    1e-6."""
    cfg = LlamaConfig.tiny(**TARGET)
    toks = np.random.RandomState(3).randint(1, 97, (30,))
    for dtype, cache in ((torch.bfloat16, "bfloat16"),
                         (torch.float32, "float32")):
        net = LlamaForCausalLM(cfg, device="cpu", seed=5, dtype=dtype)
        with torch.inference_mode():
            slab = alloc_kv_caches(cfg, 8, 64, cache, device="cpu")
            blk = alloc_kv_caches(cfg, 1, 16, cache, device="cpu")
            ids = torch.zeros((1, 16), dtype=torch.long)
            ids[0, :10] = torch.as_tensor(toks[:10])
            net(ids, caches=blk, pos=0)
            row0 = torch.tensor([0])
            for (a, b), (c, d) in zip(slab, blk):
                tkv.adopt_into_slab(a, c, 0)
                tkv.adopt_into_slab(b, d, 0)
            slab2 = [(a.clone(), b.clone()) for a, b in slab]
            vanilla = []
            for p in range(10, 30):
                tok = torch.zeros((8, 1), dtype=torch.long)
                tok[0, 0] = int(toks[p])
                pos = torch.zeros((8,), dtype=torch.int32)
                pos[0] = p
                lg, _ = decode_step(net, tok, slab, pos)
                vanilla.append(lg[0].float().clone())
            block = alloc_kv_caches(cfg, 1, 64, cache, device="cpu")
            verify = []
            for p in range(10, 30, 5):
                for (a, b), (c, d) in zip(slab2, block):
                    tkv.slab_row_block(a, row0, c)
                    tkv.slab_row_block(b, row0, d)
                body = tspec.build_verify_body(net, block, 5, False)
                verify.append(body(torch.as_tensor(toks[None, p:p + 5]),
                                   torch.tensor([p], dtype=torch.int32))
                              .float().clone())
                for (a, b), (c, d) in zip(slab2, block):
                    tkv.adopt_into_slab(a, c, row0)
                    tkv.adopt_into_slab(b, d, row0)
        vanilla, verify = torch.stack(vanilla), torch.cat(verify)
        if dtype == torch.bfloat16:
            assert torch.equal(vanilla, verify)
        else:
            assert float((vanilla - verify).abs().max()) <= 1e-6


@pytest.mark.parametrize("cache,rows", [
    ("bfloat16", 4), ("int8", 4), ("bfloat16", 2)])
def test_paged_verify_rows_equal_vanilla_rows(prompts, cache, rows):
    """C item 3 on the CPU: the paged verify (decode replays over the
    arena) scores each position with the vanilla paged decode step's row
    bit for bit, bf16 and int8 caches, also where ``k + 1`` exceeds the
    engine's rows (consecutive replays, ``rows`` 2 and k 3); the early
    exit at layer 1 rejects, so rollbacks run and the pool drains."""
    net = LlamaForCausalLM(LlamaConfig.tiny(**TARGET), device="cpu", seed=5,
                           dtype=torch.bfloat16)
    kw = dict(cache_dtype=cache, max_batch_size=rows, max_seq_len=64,
              min_bucket=8, page_size=4, demand_paging=True)
    vanilla = PagedServingEngine(net, **kw)
    van_rows = {}
    run = vanilla._programs.run

    def recording_run(key, build, *arrays):
        out = run(key, build, *arrays)
        if key == ("decode",):
            for i, seq in enumerate(vanilla._seqs):
                if seq is not None:
                    van_rows[(seq.handle.request.request_id,
                              int(arrays[1][i]))] = out[0][i].clone()
        return out

    vanilla._programs.run = recording_run
    van = vanilla.generate(prompts, max_new_tokens=MAX_NEW)
    want = [list(h.tokens) for h in van]
    spec = SpeculativeDecoder(exit_layer=1, k=3)
    eng = PagedServingEngine(net, speculative=spec, **kw)
    verify = eng._spec_verify
    ver_rows = []

    def recording_verify(slot, ids, pos):
        out = verify(slot, ids, pos)
        rid = eng._seqs[slot].handle.request.request_id
        for i in range(ids.shape[1]):
            ver_rows.append((rid, pos + i, tuple(ids[0, :i + 1]),
                             out[i].clone()))
        return out

    eng._spec_verify = recording_verify
    hs = eng.generate(prompts, max_new_tokens=MAX_NEW)
    assert [list(h.tokens) for h in hs] == want
    # request ids -> prompt index, in each engine
    spec_j = {h.request.request_id: j for j, h in enumerate(hs)}
    van_id = [h.request.request_id for h in van]
    compared = 0
    for rid, q, ctx, row in ver_rows:
        j = spec_j[rid]
        stream = list(prompts[j]) + want[j]
        p = q - len(ctx) + 1
        if q + 1 < len(stream) and tuple(stream[p:q + 1]) == ctx:
            assert torch.equal(row, van_rows[(van_id[j], q)]), (j, q)
            compared += 1
    assert compared >= 10
    assert eng.spec_pages_rolled_back > 0
    for e in (eng, vanilla):
        e.close()
        _drained(e)


# ------------------------------------------------------- greedy streams
@pytest.mark.parametrize("kind", ["slab", "paged"])
@pytest.mark.parametrize("mode", ["exit", "draft"])
def test_greedy_fp32_streams_equal_jax_generate(nets, draft_net, prompts,
                                                jax_streams, kind, mode):
    """(c) Greedy speculative streams in fp32 == JAX ``generate``, token
    for token: the early exit at layer 2 of 3 (partial acceptance) and
    a separate 1-layer draft."""
    _, tnet = nets
    spec = (SpeculativeDecoder(exit_layer=2, k=3) if mode == "exit"
            else SpeculativeDecoder(draft_net, k=4))
    eng = _engine(kind, tnet, "float32", speculative=spec)
    assert _streams(eng, prompts) == jax_streams
    assert spec.stats()["rounds"] > 0


@pytest.mark.parametrize("dtype,kind", [
    ("bfloat16", "slab"), ("bfloat16", "paged"), ("int8", "slab"),
    ("int8", "paged")])
def test_greedy_streams_equal_vanilla(nets, prompts, dtype, kind):
    """(d) bf16 (parallel verify) and int8 (sequential verify) greedy
    speculative streams == the port's vanilla engine, token for token
    (the JAX pin ``tests/test_speculative.py:107-147``)."""
    _, tnet = nets
    spec = SpeculativeDecoder(exit_layer=2, k=3)
    eng = _engine(kind, tnet, dtype, speculative=spec)
    # the slab's int8 verify runs decode sub-steps over its block; the
    # paged engine replays its decode step over the arena
    assert spec._sequential == (dtype == "int8" and kind == "slab")
    assert _streams(eng, prompts) == _vanilla(tnet, prompts, dtype)


def test_full_acceptance_at_final_layer(nets, prompts):
    """(e) ``exit_layer == num_layers``: the draft is the target, so every
    proposal is accepted and a round emits more than one token."""
    _, tnet = nets
    spec = SpeculativeDecoder(exit_layer=3, k=3, draft_cache_dtype="bfloat16")
    eng = _engine("slab", tnet, "bfloat16", speculative=spec)
    toks = _streams(eng, prompts)
    st = spec.stats()
    assert toks == _vanilla(tnet, prompts, "bfloat16")
    assert st["proposed"] > 0 and st["accepted"] == st["proposed"]
    assert st["mean_accept_length"] > 1.0
    rep = eng.metrics.report()
    assert rep["counters"]["speculative_rounds"] == st["rounds"]
    assert rep["counters"]["speculative_accepted"] == st["accepted"]
    assert rep["speculative_accept_length"]["count"] == st["rounds"]


def test_sampled_streams_equal_on_slab_and_paged(nets, draft_net, prompts):
    """(g) Position-addressed keys: the sampled speculative streams are
    the same on the slab and the paged engine."""
    _, tnet = nets
    samp = dict(do_sample=True, temperature=0.9, top_k=20, top_p=0.95,
                seed=7)
    out = []
    for kind in ("slab", "paged"):
        spec = SpeculativeDecoder(draft_net, k=3)
        out.append(_streams(_engine(kind, tnet, "float32", speculative=spec,
                                    **samp), prompts))
        assert spec.stats()["rounds"] > 0
    assert out[0] == out[1]


# ------------------------------------------------------------ residency
def test_rollback_leaks_nothing_and_shared_pages_stay(nets, prompts):
    """(h) Demand pages under rejection: verify pages are claimed and the
    rejected tails' rolled back, the pool drains to zero with claims ==
    releases; and with a prefix cache, a speculative row over a shared
    prefix never writes the shared pages."""
    _, tnet = nets
    spec = SpeculativeDecoder(exit_layer=1, k=4)
    eng = PagedServingEngine(tnet, cache_dtype="float32", max_batch_size=2,
                             max_seq_len=64, min_bucket=8, page_size=4,
                             demand_paging=True, speculative=spec)
    assert _streams(eng, prompts, close=False) == _vanilla(
        tnet, prompts, "float32")
    assert eng.spec_pages_claimed > 0 and eng.spec_pages_rolled_back > 0
    eng.close()
    _drained(eng)

    spec = SpeculativeDecoder(exit_layer=1, k=4)
    eng = PagedServingEngine(tnet, cache_dtype="float32", max_batch_size=2,
                             max_seq_len=64, min_bucket=8, page_size=8,
                             prefix_cache=True, speculative=spec)
    prefix = np.random.RandomState(8).randint(1, 97, (19,))
    eng.generate([prefix], max_new_tokens=MAX_NEW)
    turn = np.concatenate([prefix, [5, 6]])
    shared = eng.prefix_cache.match(turn, 21, eng.weights_version).pages
    assert len(shared) >= 2
    before = [t[shared].clone() for pair in eng._caches for t in pair]
    (second,) = eng.generate([turn], max_new_tokens=MAX_NEW)
    assert eng.prefix_cache.stats()["hits"] == 1
    assert all(torch.equal(t[shared], b) for t, b in zip(
        [t for pair in eng._caches for t in pair], before))
    assert second.status == "DONE"
    eng.close()
    _drained(eng)


def test_bind_validations(nets, draft_net):
    """(i) Exactly one of draft or ``exit_layer``, ``k >= 1``, the
    vocabulary match, the exit layer's range, one engine a decoder."""
    _, tnet = nets
    with pytest.raises(ValueError):
        SpeculativeDecoder()
    with pytest.raises(ValueError):
        SpeculativeDecoder(draft_net, exit_layer=1)
    with pytest.raises(ValueError):
        SpeculativeDecoder(draft_net, k=0)
    bad = LlamaForCausalLM(LlamaConfig.tiny(
        vocab_size=31, hidden_size=32, intermediate_size=64,
        num_hidden_layers=1, num_attention_heads=2), device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        ServingEngine(tnet, max_batch_size=1, max_seq_len=32,
                      speculative=SpeculativeDecoder(bad, k=2))
    with pytest.raises(ValueError, match="exit_layer"):
        ServingEngine(tnet, max_batch_size=1, max_seq_len=32,
                      speculative=SpeculativeDecoder(exit_layer=4))
    spec = SpeculativeDecoder(exit_layer=1)
    ServingEngine(tnet, max_batch_size=1, max_seq_len=32, speculative=spec)
    with pytest.raises(RuntimeError, match="already bound"):
        ServingEngine(tnet, max_batch_size=1, max_seq_len=32,
                      speculative=spec)


@pytest.mark.parametrize("kind", ["slab", "paged"])
def test_warmup_inventory_and_graphs_equal_eager(nets, draft_net, prompts,
                                                 kind):
    """(j) ``warmup()`` captures draft prefill per bucket and draft
    decode per row after the base inventory, and on the slab a verify
    per k1 in 1..k+1 over its full-width block and the gather (the paged
    verify replays the decode program: no program of its own); a second
    call nothing, traffic nothing more (the paged engine's
    ``serving::spec_verify`` then counts its verify replays, one a
    round at k1 <= rows); the program streams (sampled, a separate draft)
    equal ``graphs=False``."""
    _, tnet = nets
    samp = dict(do_sample=True, temperature=0.9, seed=3)
    out = []
    for graphs in (True, False):
        spec = SpeculativeDecoder(draft_net, k=3)
        eng = _engine(kind, tnet, "float32", speculative=spec, graphs=graphs,
                      **samp)
        if graphs:
            nb = len(eng._warmup_buckets())
            verify = 4 + 1 if kind == "slab" else 0
            assert eng.warmup()["programs"] == 1 + 2 * nb + nb + 4 + verify
            counts = eng.compile_counts()
            assert counts["serving::spec_draft_prefill"] == nb
            assert counts["serving::spec_draft_decode"] == 4
            assert counts["serving::spec_verify"] == (4 if kind == "slab"
                                                      else 0)
            assert eng.warmup()["programs"] == 0
        out.append(_streams(eng, prompts, close=False))
        if graphs:
            if kind == "paged":
                counts["serving::spec_verify"] = spec.stats()["rounds"]
            assert eng.compile_counts() == counts
        eng.close()
    assert out[0] == out[1]
