"""Sessions in the port (``paddle_tpu_torch/serving/sessions.py`` and the
engines' seams) against the JAX package's, on the CPU.

The session store's lifecycle against JAX's ``SessionStore`` under one
injected clock (touches, turns, TTL sweeps and LRU overflow give the same
``stats()``); greedy streams equal with and without a ``session_id`` on
both engines, and a finished turn recorded as prompt + answer; the
engines' constructors and ``submit`` take the JAX engines' parameters in
their order (the port's ``graphs`` last); the parameters of modules not
ported raise naming their ``ROADMAP.md`` queue A item; and
``memory_report()``: None before any capture, then one entry a captured
program (0 bytes on the CPU). No JAX engine is built: the JAX side is
its pure-Python store and the classes' signatures.
"""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu.observability.registry import MetricsRegistry  # noqa: E402
from paddle_tpu_torch.observability import (  # noqa: E402
    FlightRecorder as TFlightRecorder,
    MetricsRegistry as TMetricsRegistry,
)
from paddle_tpu.serving import PagedServingEngine as JPaged  # noqa: E402
from paddle_tpu.serving import ServingEngine as JSlab  # noqa: E402
from paddle_tpu.serving import SessionStore as JSessionStore  # noqa: E402
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM  # noqa
from paddle_tpu_torch.serving import (  # noqa: E402
    PagedServingEngine,
    ServingEngine,
    SessionStore,
    TieredPageStore,
)
from test_torch_kernels import _one_thread  # noqa: E402,F401  (autouse)

CFG = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
           num_hidden_layers=2, num_attention_heads=4)
GEOM = dict(max_batch_size=2, max_seq_len=64, min_bucket=8)


@pytest.fixture(scope="module")
def net():
    return LlamaForCausalLM(LlamaConfig.tiny(**CFG), device="cpu", seed=5)


def _engine(kind, net, **kw):
    if kind == "slab":
        return ServingEngine(net, cache_dtype="float32", **GEOM, **kw)
    return PagedServingEngine(net, cache_dtype="float32", page_size=8,
                              prefix_cache=True, **GEOM, **kw)


# ------------------------------------------------------------ the store
def test_store_lifecycle_equals_jax_under_one_clock():
    """One script of touches, turns, TTL sweeps and LRU overflow through
    both stores on one injected clock: the same ``stats()`` after every
    call, the same live sessions, tokens and turns."""
    t = [0.0]
    clock = lambda: t[0]  # noqa: E731
    port = SessionStore(max_sessions=3, ttl_s=10.0, clock=clock)
    jax_ = JSessionStore(max_sessions=3, ttl_s=10.0, clock=clock,
                         registry=MetricsRegistry())
    script = [
        (0.0, "touch", "a"), (1.0, "touch", "b"),
        (2.0, "note_turn", "a", [1, 2, 3]), (3.0, "touch", "c"),
        (4.0, "touch", "a"), (5.0, "touch", "d"),       # LRU retires b
        (6.0, "note_turn", "ghost", [9]), (7.0, "note_turn", "d", [4, 5]),
        (14.5, "sweep"),                                 # TTL: c, a
        (15.0, "touch", "e"), (16.0, "touch", "f"),
        (30.0, "touch", "d"),                            # TTL: d, e, f
        (31.0, "note_turn", "d", [6, 7, 8]), (32.0, "sweep"),
    ]
    for now, op, *args in script:
        t[0] = now
        for store in (port, jax_):
            getattr(store, op)(*args)
        assert port.stats() == jax_.stats(), (now, op, args)
        assert len(port) == len(jax_)
        for sid in "abcdef":
            p, j = port.get(sid), jax_.get(sid)
            assert (p is None) == (j is None), sid
            if p is not None:
                assert (p.tokens, p.turns, p.last_active) == (
                    j.tokens, j.turns, j.last_active)
    assert port.stats()["retired"] == {"lru": 1, "ttl": 5}
    for store in (port, jax_):
        store.close()
    assert len(port) == 0 and port.stats() == jax_.stats()


# ---------------------------------------------------------- the engines
@pytest.mark.parametrize("kind", ["slab", "paged"])
def test_streams_equal_with_and_without_session(net, kind):
    """Sessions never change a stream: two turns of one conversation with
    a ``session_id`` equal the same prompts without one, and each
    finished turn is recorded as its prompt + answer."""
    rng = np.random.RandomState(7)
    p1 = rng.randint(0, 64, (11,))
    user = rng.randint(0, 64, (5,))
    out = []
    for sid in ("chat-1", None):
        eng = _engine(kind, net, sessions=True)
        (h1,) = eng.generate([p1], max_new_tokens=6, session_id=sid)
        p2 = np.concatenate([h1.output_ids, user])
        (h2,) = eng.generate([p2], max_new_tokens=6, session_id=sid)
        assert h1.status == h2.status == "DONE"
        out.append((h1.tokens, h2.tokens))
        st = eng.sessions.stats()
        if sid is None:
            assert st["created"] == st["turns"] == 0
        else:
            s = eng.sessions.get(sid)
            assert s.turns == 2 and st["turns"] == 2 and st["created"] == 1
            assert s.tokens == tuple(int(t) for t in h2.output_ids)
            if kind == "paged":
                # turn 2 warm-hit turn 1's prompt and answer pages
                assert eng.prefix_cache.stats()["hits"] == 1
        eng.close()
        assert eng.sessions.stats()["active"] == 0
    assert out[0] == out[1]
    ref = net.generate(p1[None], max_new_tokens=6, cache_dtype="float32")
    assert out[0][0] == [int(t) for t in ref[0, 11:]]


def test_sessions_argument_forms(net):
    """``sessions=True`` builds a store on the engine's clock, a built
    store passes through, ``False`` and ``None`` build none; a closed
    engine records nothing."""
    t = [5.0]
    eng = _engine("slab", net, sessions=True, clock=lambda: t[0])
    assert isinstance(eng.sessions, SessionStore)
    assert eng.sessions.touch("x").created == 5.0
    store = SessionStore()
    assert _engine("slab", net, sessions=store).sessions is store
    assert _engine("slab", net, sessions=False).sessions is None
    assert _engine("paged", net).sessions is None
    eng.close()
    h = eng.submit(np.arange(4), 2, session_id="late")
    assert h.status == "REJECTED" and eng.sessions.get("late") is None


# ------------------------------------------------ the parameter lists
@pytest.mark.parametrize("port,ref,extra", [
    (ServingEngine.__init__, JSlab.__init__, ["graphs"]),
    (PagedServingEngine.__init__, JPaged.__init__, ["graphs"]),
    (ServingEngine.submit, JSlab.submit, []),
    (PagedServingEngine.submit, JPaged.submit, [])])
def test_parameter_lists_equal_jax(port, ref, extra):
    """C item 5: the port's constructors and ``submit`` take the JAX
    engines' parameters in their order and with their defaults (the
    callables aside), the port's ``graphs`` after them."""
    ps = inspect.signature(port).parameters
    js = inspect.signature(ref).parameters
    assert list(ps) == list(js) + extra
    for name, p in js.items():
        q = ps[name]
        assert q.kind == p.kind, name
        if not callable(p.default):
            assert q.default == p.default, name


class _IdleTransport:
    """A prefill transport the engine holds and closes but never calls
    here (no cold admission runs)."""

    closed = False

    def available(self):
        return False

    def close(self):
        self.closed = True


@pytest.mark.parametrize("kind,kw,item", [
    ("slab", dict(recompile_guard_max=4), "queue A item 1.6"),
    ("slab", dict(reload_template=object()), "queue A item 1.5"),
    ("paged", dict(recompile_guard_max=4), "queue A item 1.6"),
    ("paged", dict(reload_template=object()), "queue A item 1.5"),
    ("paged", dict(prefill_transport=_IdleTransport()), "queue A item 1.7")])
def test_refusals_name_their_items(net, kind, kw, item):
    """The parameters these items once refused are taken now. Live reload
    (item 1.5): ``reload_template`` is the default template of
    ``prepare_reload``; the trace guard (item 1.6): ``recompile_guard_max``
    sets its storm bar; remote prefill (item 1.7): ``prefill_transport``
    is held, and ``close()`` closes it."""
    if item == "queue A item 1.5":
        eng = _engine(kind, net, **kw)
        assert eng._reload_template is kw["reload_template"]
        eng.close()
        return
    if item == "queue A item 1.6":
        eng = _engine(kind, net, **kw)
        assert eng.trace_guard.max_compiles == kw["recompile_guard_max"]
        eng.close()
        return
    transport = kw["prefill_transport"]
    eng = _engine(kind, net, **kw)
    assert eng.prefill_transport is transport and not transport.closed
    assert (eng.remote_prefills, eng.remote_prefill_fallbacks) == (0, 0)
    eng.close()
    assert transport.closed


def test_store_refusals_and_tier_needs_prefix_cache(net):
    """The stores take ``registry=`` and ``recorder=`` as JAX's do (their
    series land in the registry given); a tier without a prefix cache is
    refused as JAX refuses it."""
    for cls, name in ((SessionStore, "paddle_serving_sessions_active"),
                      (TieredPageStore, "paddle_serving_kv_tier_pages")):
        reg = TMetricsRegistry()
        store = cls(registry=reg, recorder=TFlightRecorder(registry=reg))
        assert reg.get(name) is not None
        assert store._rec.registry is reg
    with pytest.raises(ValueError, match="requires prefix_cache"):
        PagedServingEngine(net, page_size=8, kv_tiering=True, **GEOM)
    # the accepted scheduler/metrics/pool are used as given
    eng = _engine("slab", net)
    other = ServingEngine(net, scheduler=eng.scheduler, metrics=eng.metrics,
                          pool=eng.pool, **GEOM)
    assert (other.scheduler, other.metrics, other.pool) == (
        eng.scheduler, eng.metrics, eng.pool)


# ------------------------------------------------------- memory_report
@pytest.mark.parametrize("kind", ["slab", "paged"])
def test_memory_report_lists_the_captured_programs(net, kind):
    """``memory_report()`` is None before any capture; after
    ``warmup()`` its keys are the captured inventory's JAX names, each
    count 0 on the CPU."""
    eng = _engine(kind, net)
    assert eng.memory_report() is None
    n = eng.warmup()["programs"]
    rep = eng.memory_report()
    names = set()
    for key in eng._programs._progs:
        kind_ = key[0]
        names.add({"decode": "decode", "prefill": "prefill_b{}",
                   "adopt": "adopt_b{}", "gather": "gather_b{}",
                   "chunk": "chunk_b{}_t{}"}[kind_].format(*key[1:]))
    assert set(rep["programs"]) == names and len(names) == n
    assert "decode" in names and "prefill_b8" in names
    assert rep["max_peak_bytes"] == 0
    assert all(e == {"graph_pool_bytes": 0, "peak_bytes": 0,
                     "static_bytes": 0} for e in rep["programs"].values())
    eng.close()
