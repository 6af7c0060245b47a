"""The port's HTTP/SSE front end (``paddle_tpu_torch/serving/
http_frontend.py``) over a tiny fp32 paged engine on 127.0.0.1.

One module-scoped server: SSE streams equal JAX ``generate`` and the
port's ``generate`` on the same weights; ``"stream": false``; the status
codes before a stream opens (429 ``queue_full``, 413 ``too_long``, 400
malformed, 503 ``draining``) and the terminal ``event: error`` of a
request past its deadline; drain and undrain; ``POST /reload`` of a port
checkpoint, and a request that arrives while a reload is being
prepared; ``/healthz``'s keys equal the JAX front end's for the same
engine (JAX's ``_health_snapshot`` run over the port's engine);
``/metrics`` read by JAX's parser; ``/trace`` spans under a client
``traceparent``; per-class histogram children bound once per admission;
no capture across traffic; ``driver_errors`` empty.
"""
import http.client
import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu import observability as jobs  # noqa: E402
from paddle_tpu.core.tensor import Tensor  # noqa: E402
from paddle_tpu.models import LlamaConfig as JConfig  # noqa: E402
from paddle_tpu.models import LlamaForCausalLM as JLlama  # noqa: E402
from paddle_tpu.observability.slo import SLOMonitor as JMonitor  # noqa
from paddle_tpu.serving.http_frontend import (  # noqa: E402
    ServingFrontend as JFrontend,
)
from paddle_tpu_torch import observability as obs  # noqa: E402
from paddle_tpu_torch.checkpoint import CheckpointManager  # noqa: E402
from paddle_tpu_torch.convert import load_numpy_state  # noqa: E402
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM  # noqa
from paddle_tpu_torch.serving import (  # noqa: E402
    HTTPRejected,
    PagedServingEngine,
    ServingFrontend,
    ServingMetrics,
    read_sse_events,
    stream_generate,
)
from test_torch_kernels import _one_thread  # noqa: E402,F401  (autouse)

CFG = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
           num_hidden_layers=2, num_attention_heads=4)
RNG = np.random.RandomState(21)
PROMPTS = [[int(t) for t in RNG.randint(0, 64, (n,))] for n in (9, 9, 9)]
NEW = 7


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
def server(nets):
    _, tnet = nets
    tracer = obs.Tracer(process="test", sample=1)
    prev = obs.set_tracer(tracer)
    eng = PagedServingEngine(tnet, cache_dtype="float32", max_batch_size=2,
                             max_seq_len=64, min_bucket=8, page_size=8,
                             prefix_cache=True, sessions=True,
                             max_queue_size=3)
    fe = ServingFrontend(eng, port=0).start()  # warms the engine first
    yield fe, eng, tracer
    fe.stop(close_engine=True)
    obs.set_tracer(prev)
    assert not fe.driver_errors, list(fe.driver_errors)


def _get(fe, path):
    conn = http.client.HTTPConnection("127.0.0.1", fe.port, timeout=60)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def _post(fe, path, body, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", fe.port, timeout=60)
    try:
        conn.request("POST", path, body=json.dumps(body),
                     headers=dict({"Content-Type": "application/json"},
                                  **(headers or {})))
        r = conn.getresponse()
        if r.getheader("Content-Type") == "text/event-stream":
            return r.status, list(read_sse_events(r))
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def _stream_tokens(fe, ids, new=NEW, **extra):
    events, _ = stream_generate("127.0.0.1", fe.port,
                                dict({"input_ids": ids,
                                      "max_new_tokens": new}, **extra),
                                timeout=60)
    assert events[-1][0] == "done", events[-1]
    toks = [d["token"] for e, d in events if e == "token"]
    assert toks == events[-1][1]["tokens"]
    return toks


def test_streams_equal_jax_and_port_generate(nets, server):
    jnet, tnet = nets
    fe, eng, _ = server
    captures = eng.trace_guard.compile_counts()
    out = [None] * len(PROMPTS)

    def run(i):
        out[i] = _stream_tokens(fe, PROMPTS[i])

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(PROMPTS))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    # the three prompts have one length: one batched call of each
    ids = np.asarray(PROMPTS, np.int32)
    want = np.asarray(jnet.generate(Tensor(jnp.asarray(ids)),
                                    max_new_tokens=NEW,
                                    cache_dtype="float32").numpy())
    port = tnet.generate(ids, max_new_tokens=NEW, cache_dtype="float32",
                         graphs=False)
    for i, toks in enumerate(out):
        assert toks == [int(t) for t in want[i, ids.shape[1]:]]
        assert toks == [int(t) for t in port[i, ids.shape[1]:]]
    # the engine was warmed by start(): traffic captures nothing
    assert eng.trace_guard.compile_counts() == captures
    assert not eng.trace_guard.findings


def test_blocking_response_and_rejections(server):
    fe, eng, _ = server
    st, body = _post(fe, "/v1/generate", {"input_ids": PROMPTS[0],
                                          "max_new_tokens": 3,
                                          "stream": False})
    assert st == 200 and body["status"] == "DONE" and \
        len(body["tokens"]) == 3
    for bad in ({"input_ids": "x"}, {"input_ids": []},
                {"input_ids": [1], "max_new_tokens": 0},
                {"input_ids": [1], "slo_class": "nope"},
                {"input_ids": [1], "deadline_s": -1}):
        st, body = _post(fe, "/v1/generate", bad)
        assert st == 400, (bad, body)
    with pytest.raises(HTTPRejected) as e:
        stream_generate("127.0.0.1", fe.port,
                        {"input_ids": [1] * 70, "max_new_tokens": 2})
    assert e.value.code == 413 and e.value.body["reason"] == "too_long"
    st, _ = _post(fe, "/nope", {})
    assert st == 404


def test_queue_full_and_deadline(server):
    """With admission held (the engine reports no free row), two queued
    requests and a third with a deadline of 0: that stream ends with a
    terminal ``timeout`` error; a full queue answers the next POST with
    429 before a stream opens; released, the queue drains."""
    fe, eng, _ = server
    with fe._lock:
        eng._has_capacity = lambda: False
        queued = [eng.submit(np.asarray(PROMPTS[1]), 2) for _ in range(2)]
    try:
        st, body = _post(fe, "/v1/generate", {"input_ids": PROMPTS[2],
                                              "max_new_tokens": 2,
                                              "deadline_s": 0.0})
        assert st == 200 and body[-1][0] == "error"
        assert body[-1][1]["reason"] == "timeout"
        with fe._lock:
            queued.append(eng.submit(np.asarray(PROMPTS[1]), 2))
            assert eng.scheduler.depth == 3
        with pytest.raises(HTTPRejected) as e:
            stream_generate("127.0.0.1", fe.port,
                            {"input_ids": PROMPTS[2], "max_new_tokens": 2})
        assert e.value.code == 429
        assert e.value.body["reason"] == "queue_full"
    finally:
        with fe._lock:
            del eng._has_capacity
    for h in queued:
        while not h.finished:
            threading.Event().wait(0.01)
        assert h.status == "DONE"


def test_drain_and_undrain(server):
    fe, eng, _ = server
    first = threading.Event()
    done = []

    def inflight():
        conn = http.client.HTTPConnection("127.0.0.1", fe.port, timeout=60)
        conn.request("POST", "/v1/generate", body=json.dumps(
            {"input_ids": PROMPTS[1], "max_new_tokens": 12}))
        for ev, data in read_sse_events(conn.getresponse()):
            first.set()
            if ev in ("done", "error"):
                done.append(ev)
                break
        conn.close()

    t = threading.Thread(target=inflight)
    t.start()
    assert first.wait(30)
    st, health = _post(fe, "/drain", {})
    assert st == 200 and health["draining"] and not health["accepting"]
    st, body = _post(fe, "/v1/generate", {"input_ids": [1, 2]})
    assert (st, body["reason"]) == (503, "draining")
    t.join()
    assert done == ["done"]
    st, health = _post(fe, "/undrain", {})
    assert st == 200 and health["accepting"]
    assert _stream_tokens(fe, PROMPTS[0], 2)


def test_health_keys_equal_jax_and_memory(server):
    fe, eng, _ = server
    st, raw = _get(fe, "/healthz")
    got = json.loads(raw)
    jfe = JFrontend.__new__(JFrontend)
    jfe.engine, jfe.draining = eng, False
    jfe.slo_monitor = JMonitor(registry=jobs.MetricsRegistry())
    assert st == 200 and set(got) == set(jfe._health_snapshot())
    assert got["memory"] == json.loads(json.dumps(eng.memory_report()))
    assert got["compile_entries"] == sum(
        eng.trace_guard.compile_counts().values())
    for key in ("pool", "page_pool", "prefix_cache", "sessions"):
        assert isinstance(got[key], dict), key
    st, raw = _get(fe, "/alerts")
    assert st == 200 and "rules" in json.loads(raw)


def test_metrics_read_by_jax_parser_and_trace_under_client_span(server):
    fe, eng, tracer = server
    client = obs.SpanContext("ab" * 16, "cd" * 8)
    st, events = _post(fe, "/v1/generate",
                       {"input_ids": PROMPTS[2], "max_new_tokens": 5},
                       headers={"traceparent": client.traceparent()})
    assert st == 200 and events[-1][0] == "done"
    st, raw = _get(fe, "/metrics")
    text = raw.decode()
    assert jobs.parse_prometheus_text(text) == \
        obs.parse_prometheus_text(text)
    parsed = jobs.parse_prometheus_text(text)
    assert parsed["paddle_serving_wire_ttft_seconds_count"][0][1] >= 1
    for _ in range(200):  # the handler finishes its span after "done"
        spans = {s["name"]: s for s in tracer.buffer.get(client.trace_id)}
        if "frontend.request" in spans:
            break
        threading.Event().wait(0.01)
    req = spans["frontend.request"]
    assert req["parent_id"] == client.span_id
    for name in ("engine.queue_wait", "engine.prefill", "engine.decode",
                 "engine.adopt"):
        assert spans[name]["parent_id"] == req["span_id"], name
    steps = [e for e in spans["engine.decode"]["events"]
             if e["name"] == "decode_step"]
    assert len(steps) == 4  # 5 tokens: the first from the prefill
    st, raw = _get(fe, "/trace")
    assert client.trace_id in {t["trace_id"]
                               for t in json.loads(raw)["traces"]}


def test_slo_children_bound_once_per_admission(server):
    """JAX ``tests/test_slo.py``: one ``slo_children`` call an admission,
    one label resolution a class, every ITL sample in the child."""
    fe, eng, _ = server
    m = ServingMetrics(registry=obs.MetricsRegistry())
    calls = {"children": 0, "labels": 0}
    orig_children, orig_labels = m.slo_children, m.itl.labels

    def children(cls):
        calls["children"] += 1
        return orig_children(cls)

    def labels(**kw):
        calls["labels"] += 1
        return orig_labels(**kw)

    m.slo_children, m.itl.labels = children, labels
    with fe._lock:
        old, eng.metrics = eng.metrics, m
    try:
        _stream_tokens(fe, PROMPTS[0], 8, slo_class="rag")
        _stream_tokens(fe, PROMPTS[1], 8, slo_class="rag")
    finally:
        with fe._lock:
            eng.metrics = old
    assert calls == {"children": 2, "labels": 1}
    series = m.itl.data()["series"]
    assert [s["labels"] for s in series] == [{"slo_class": "rag"}]
    assert series[0]["count"] == m.itl.count == 14


def test_reload_over_http_and_a_request_during_prepare(nets, server,
                                                       tmp_path):
    """``POST /reload`` of a port checkpoint of another net: the streams
    after it are that net's; a stream that arrives while the reload is
    being prepared on its handler thread finishes on the old weights.
    The original weights are reloaded after."""
    _, tnet = nets
    fe, eng, _ = server
    other = LlamaForCausalLM(LlamaConfig.tiny(**CFG), device="cpu",
                             seed=9).eval()
    roots = {}
    for name, net in (("other", other), ("orig", tnet)):
        mgr = CheckpointManager(str(tmp_path / name), network=net,
                                async_saves=False)
        mgr.save(1, blocking=True)
        mgr.close()
        roots[name] = str(tmp_path / name)
    before = _stream_tokens(fe, PROMPTS[0])
    want = other.generate(np.asarray(PROMPTS[0])[None], max_new_tokens=NEW,
                          cache_dtype="float32", graphs=False)
    want = [int(t) for t in want[0, len(PROMPTS[0]):]]
    assert want != before
    # hold the prepare until a stream has been served beside it
    prepare, streamed = eng.prepare_reload, threading.Event()
    during = []

    def slow_prepare(*a, **kw):
        staged = prepare(*a, **kw)
        during.append(_stream_tokens(fe, PROMPTS[0]))
        streamed.set()
        return staged

    eng.prepare_reload = slow_prepare
    try:
        st, body = _post(fe, "/reload", {"ckpt_dir": roots["other"],
                                         "weights_version": "other"})
    finally:
        del eng.prepare_reload
    assert streamed.is_set() and during == [before]
    assert st == 200 and body["ok"] and body["applied"]
    assert body["health"]["weights_version"] == "other"
    assert _stream_tokens(fe, PROMPTS[0]) == want
    st, body = _post(fe, "/reload", {"ckpt_dir": str(tmp_path / "none")})
    assert st == 409 and not body["ok"]
    st, body = _post(fe, "/reload", {"ckpt_dir": roots["orig"],
                                     "weights_version": "v0"})
    assert st == 200 and body["applied"]
    assert _stream_tokens(fe, PROMPTS[0]) == before
    assert eng.metrics.reloads.by_label()["ok"] >= 2
