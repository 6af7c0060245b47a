"""The port's observability core against the JAX package's
(``paddle_tpu_torch/observability``, ``analysis/trace_guard.py``).

- the registry, the exposition and the parser: for the same observations
  (counters, hostile label values, lazy and labelled gauges, histograms
  with labelled children, exemplars) the port's ``prometheus_text`` is
  byte-identical to JAX's, each package's parser reads the other's text,
  and the registry cases of the JAX package's own tests hold on the port;
  a lazy CUDA value (a stub event) is skipped by a nonblocking scrape
  while not ready;
- tracing: span lifecycle, head sampling, buffer and event-ring bounds,
  and ``traceparent`` crossing between the packages both ways;
- SLO: the ring math, budget interpolation, the class registry, the
  burn-rate lifecycle with its flight-recorder events, the bundle's SLO
  section;
- the flight recorder: the ring bound, a dump of lazy tensor values,
  ``watch``, and the NaN hook's slot armed by ``install``;
- the step meter: analytic FLOPs equal JAX's on a tiny Llama, MFU absent
  without a peak, throughput, a run break, torch batch geometry;
- the trace guard: a storm fires past ``max_compiles``; a warmed tiny
  paged engine records no capture across traffic; both engines take
  ``recompile_guard_max`` with JAX's default bar;
- the session store, the spill tier and the checkpoint manager publish
  into the registry given and note JAX's flight-recorder events.
"""
import inspect
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")


from paddle_tpu import observability as jobs  # noqa: E402
from paddle_tpu.models import LlamaConfig as JConfig  # noqa: E402
from paddle_tpu.observability import tracing as jtracing  # noqa: E402
from paddle_tpu.serving import PagedServingEngine as JPaged  # noqa: E402
from paddle_tpu.serving import ServingEngine as JSlab  # noqa: E402
from paddle_tpu.serving import SessionStore as JSessionStore  # noqa: E402
from paddle_tpu.serving import TieredPageStore as JTier  # noqa: E402
from paddle_tpu_torch import observability as obs  # noqa: E402
from paddle_tpu_torch.analysis import TraceGuard  # noqa: E402
from paddle_tpu_torch.checkpoint import CheckpointManager  # noqa: E402
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM  # noqa
from paddle_tpu_torch.observability import flight_recorder as tfr  # noqa
from paddle_tpu_torch.observability import tracing as ttracing  # noqa: E402
from paddle_tpu_torch.observability.registry import (  # noqa: E402
    DeviceValue,
    nonblocking_values,
)
from paddle_tpu_torch.observability.slo import (  # noqa: E402
    BurnRateRule,
    SLOClass,
    SLOMonitor,
    SLORegistry,
    UnknownSLOClassError,
    default_classes,
    within_budget,
)
from paddle_tpu_torch.serving import (  # noqa: E402
    PagedServingEngine,
    ServingEngine,
    ServingMetrics,
    SessionStore,
    TieredPageStore,
)
from test_torch_kernels import _one_thread  # noqa: E402,F401  (autouse)

CFG = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
           num_hidden_layers=2, num_attention_heads=4,
           max_position_embeddings=128)


# ------------------------------------------ exposition, byte for byte
HOSTILE = ('shape={"b": 2}', "a\\nb", 'q"uote', "tail\\", "cr\rlf\nend")


def _observe(o, case):
    """One script of observations on a fresh registry of package ``o``."""
    reg = o.MetricsRegistry()
    if case == "counters":
        c = reg.counter("burn_total", help="burned")
        c.inc(4, kind='a b"c')
        c.labels(kind="x").inc(2)
        m = reg.counter("mix_total")
        m.inc(3)
        m.inc(2, kind="a")
    elif case == "hostile_labels":
        c = reg.counter("hostile_total")
        for v in HOSTILE:
            c.inc(1, graph=v)
    elif case == "gauges":
        g = reg.gauge("temp", help="degrees", unit="c")
        g.set(1.5, device="cpu:0")
        g.set(lambda: 7.25, device="lazy")
        g.set(-0.0)
        reg.gauge("empty")
    elif case == "histograms":
        h = reg.histogram("lat_seconds", help="latency")
        for v in (0.0001, 0.002, 0.03, 0.4, 7.0, 99.0):
            h.observe(v)
        q = reg.histogram("depth", buckets=(0.0, 1.0, 4.0))
        q.observe(0)
        q.observe(3)
    elif case == "exemplars":
        h = reg.histogram("ttft_seconds")
        h.observe(0.02, trace_id="ab" * 16)
        h.observe(3.0, trace_id="cd" * 16)
        c = reg.counter("aborts_total")
        c.inc(1, trace_id="ef" * 16, reason="stall")
        c.inc(1, trace_id="01" * 16)
    elif case == "labelled_children":
        h = reg.histogram("itl_seconds")
        for cls, vs in (("interactive", (0.001, 0.2)), ("rag", (0.05,))):
            child = h.labels(slo_class=cls)
            for v in vs:
                child.observe(v, trace_id="77" * 16)
        h.observe(0.3)
    return reg


CASES = ("counters", "hostile_labels", "gauges", "histograms", "exemplars",
         "labelled_children")


@pytest.mark.parametrize("case", CASES)
def test_exposition_byte_identical_and_cross_parsed(case):
    for exemplars in (False, True):
        want = jobs.prometheus_text(_observe(jobs, case),
                                    exemplars=exemplars)
        got = obs.prometheus_text(_observe(obs, case), exemplars=exemplars)
        assert got == want
        for text in (got, want):
            assert obs.parse_prometheus_text(text, exemplars=exemplars) == \
                jobs.parse_prometheus_text(text, exemplars=exemplars)
    # the JSON snapshot has the same shape too
    assert json.dumps(_observe(obs, case).snapshot(), sort_keys=True) == \
        json.dumps(_observe(jobs, case).snapshot(), sort_keys=True)


def test_registry_cases_hold_on_the_port():
    """JAX ``tests/test_observability.py``'s registry and exporter cases,
    on the port's instruments."""
    reg = obs.MetricsRegistry()
    c = reg.counter("reqs_total")
    c.inc()
    c.inc(2, route="a")
    c.labels(route="b").inc(3)
    assert c.value == 6
    assert c.series() == {(("route", "a"),): 2, (("route", "b"),): 3}
    calls = []
    g = reg.gauge("g")
    g.set(lambda: calls.append(1) or 7.0)
    assert calls == [] and g.value() == 7.0 and len(calls) == 1
    g.set(torch.tensor(2.5))  # a device scalar (here on the CPU)
    assert g.value() == 2.5
    h = obs.Histogram("h", maxlen=8)
    for i in range(20):
        h.observe(float(i))
    s = h.snapshot()
    assert (s["count"], s["sum"], s["window_count"], s["min"]) == (
        20, sum(range(20)), 8, 12.0)
    assert h.cumulative_buckets()[-1][1] == 20
    with pytest.raises(TypeError):
        reg.gauge("reqs_total")
    a = obs.Counter("c", prom_name="c_total")
    b = obs.Counter("c", prom_name="c_total")
    reg.register(a)
    a.inc(5)
    reg.register(b)
    assert reg.get("c_total") is b and b.value == 0
    with pytest.raises(ValueError):
        obs.parse_prometheus_text("this is { not exposition")
    srv = obs.start_metrics_server(port=0, registry=reg)
    try:
        import urllib.request

        body = urllib.request.urlopen(srv.url, timeout=10).read()
        assert "reqs_total" in obs.parse_prometheus_text(body.decode())
    finally:
        srv.stop()


class _Event:
    """A CUDA event's ``query()`` surface (the CPU has no CUDA event)."""

    def __init__(self):
        self.done = False

    def query(self):
        return self.done


def test_lazy_device_value_skipped_until_ready():
    reg = obs.MetricsRegistry()
    g = reg.gauge("loss")
    ev = _Event()
    g.set(DeviceValue(torch.tensor(3.5), ev))
    with nonblocking_values():
        assert g.data()["series"] == []         # in flight: skipped
        assert "loss" not in obs.parse_prometheus_text(
            obs.prometheus_text(reg))
    assert g.value() == 3.5                     # a blocking read waits
    ev.done = True
    with nonblocking_values():
        assert g.data()["series"] == [{"labels": {}, "value": 3.5}]
    # a flight bundle without sync reprs what is still in flight
    ev.done = False
    rec = obs.FlightRecorder(registry=reg)
    rec.record_step({"step": 1, "loss": DeviceValue(torch.tensor(1.0), ev)})
    assert isinstance(rec.bundle(sync=False)["steps"][0]["loss"], str)
    assert rec.bundle()["steps"][0]["loss"] == 1.0


# ---------------------------------------------------------------- tracing
def test_span_lifecycle_sampling_and_bounds():
    tr = obs.Tracer(process="test", sample=1)
    root = tr.start_trace("router.request", stream=True)
    child = tr.start_span("frontend.request", root, replica=0)
    child.event("mark", k=1)
    child.finish(status="DONE")
    root.finish(outcome="done")
    root.finish()
    spans = {s["name"]: s for s in tr.buffer.get(root.trace_id)}
    assert len(spans) == 2
    assert spans["frontend.request"]["parent_id"] == root.span_id
    assert spans["frontend.request"]["attrs"]["status"] == "DONE"
    assert spans["router.request"]["parent_id"] is None
    t3 = obs.Tracer(process="p", sample=3)
    assert sum(t3.start_trace("r") is not None for _ in range(9)) == 3
    off = obs.Tracer(process="p", sample=0)
    assert off.start_trace("r") is None
    assert off.record_span("c", None, 0.5) is None
    assert off.spans_started == 0
    buf = obs.SpanBuffer(max_spans=10, max_traces=3)
    for t in range(6):
        for i in range(4):
            buf.add({"trace_id": f"t{t}", "span_id": f"s{i}", "name": "x",
                     "start": float(i), "end": float(i)})
    assert len(buf) <= 10 and "t5" in buf.trace_ids()
    tr8 = obs.Tracer(process="p", sample=1, event_ring=8)
    sp = tr8.start_trace("engine.decode")
    for step in range(50):
        sp.event("decode_step", step=step)
    sp.finish()
    evs = tr8.buffer.get(sp.trace_id)[0]["events"]
    assert [e["step"] for e in evs] == list(range(42, 50))


@pytest.mark.parametrize("src,dst", [(ttracing, jtracing),
                                     (jtracing, ttracing)])
def test_traceparent_crosses_packages(src, dst):
    sp = src.Tracer(process="a", sample=1).start_trace("r")
    hdr = src.format_traceparent(sp)
    ctx = dst.parse_traceparent(hdr)
    assert (ctx.trace_id, ctx.span_id, ctx.sampled) == (
        sp.trace_id, sp.span_id, True)
    child = dst.Tracer(process="b", sample=1).start_span("c", hdr)
    assert child.trace_id == sp.trace_id and child.parent_id == sp.span_id
    assert dst.parse_traceparent(hdr[:-2] + "00").sampled is False
    for bad in (None, "", "garbage", "00-zz-yy-01", hdr + "-extra"):
        assert dst.parse_traceparent(bad) is None


# -------------------------------------------------------------------- SLO
def test_ring_math_and_budget_interpolation():
    ring = obs.TimeSeriesRing(capacity=64)
    for t in range(5000):
        ring.append(float(t), {"c": float(t)})
    assert len(ring) == 64
    assert [t for t, _ in ring.window(2.0, now=4999.0)] == [
        4996.0, 4997.0, 4998.0, 4999.0]
    ring = obs.TimeSeriesRing(capacity=16)
    for t, v in enumerate([10.0, 14.0, 2.0, 5.0]):
        ring.append(float(t), {"c": v})
    assert ring.delta("c") == (14.0 - 10.0) + (5.0 - 2.0)  # reset skipped
    buckets = [{"le": 0.1, "count": 4}, {"le": 1.0, "count": 8},
               {"le": float("inf"), "count": 10}]
    assert within_budget(buckets, 0.55) == pytest.approx(6.0)
    assert within_budget(buckets, 5.0) == 8.0
    reg = SLORegistry()
    assert reg.names() == ["agent", "batch", "interactive", "rag"]
    assert reg.validate(None) == "interactive"
    with pytest.raises(UnknownSLOClassError):
        reg.validate("nope")
    assert {c.name for c in default_classes()} == set(reg.names())


def test_burn_rate_fire_and_clear_order_and_bundle_section():
    """JAX ``tests/test_slo.py``'s lifecycle on the port: both windows
    fire on a sudden breach, the fast one clears first, with matching
    flight-recorder events; the bundle carries the monitor's section."""
    reg = obs.MetricsRegistry()
    m = ServingMetrics(registry=reg)
    rec = obs.FlightRecorder(registry=reg)
    rule = BurnRateRule("ord_ttft", "interactive", metric="ttft",
                        fast_window_s=2.0, slow_window_s=8.0,
                        fast_burn=2.0, slow_burn=1.0, min_requests=2)
    mon = SLOMonitor(registry=reg, slo_registry=SLORegistry([
        SLOClass("interactive", ttft_p99_s=0.25, itl_p99_s=5.0,
                 e2e_p99_s=60.0, target=0.9)]), rules=[rule], recorder=rec)
    child = m.ttft.labels(slo_class="interactive")
    mon.sample(now=0.0)
    for _ in range(5):
        child.observe(0.01)
    mon.sample(now=1.0)
    assert mon.active_alerts() == []
    for _ in range(4):
        child.observe(0.9)
    mon.sample(now=2.0)
    active = {a["rule"]: a for a in mon.active_alerts()}
    assert set(active) == {"ord_ttft:fast", "ord_ttft:slow"}
    assert active["ord_ttft:fast"]["burn"] == pytest.approx(
        (1 - 5 / 9) / 0.1)
    for _ in range(6):
        child.observe(0.01)
    mon.sample(now=3.0)
    mon.sample(now=5.5)
    assert [a["rule"] for a in mon.active_alerts()] == ["ord_ttft:slow"]
    mon.sample(now=14.0)
    mon.sample(now=15.0)
    assert mon.active_alerts() == []
    assert [(e["kind"], e["rule"]) for e in rec.events()
            if e["kind"].startswith("slo_alert")] == [
        ("slo_alert", "ord_ttft:fast"), ("slo_alert", "ord_ttft:slow"),
        ("slo_alert_cleared", "ord_ttft:fast"),
        ("slo_alert_cleared", "ord_ttft:slow")]
    sec = rec.bundle()["sections"]["slo"]
    assert sec["active_alerts"] == []
    assert sec["window_samples"][-1]["values"][
        "ttft.interactive.total"] == 15.0


# -------------------------------------------------------- flight recorder
def test_flight_recorder_ring_dump_watch_and_nan_slot(tmp_path):
    rec = obs.FlightRecorder(capacity=4, dump_dir=str(tmp_path),
                             registry=obs.MetricsRegistry())
    for i in range(10):
        rec.record_step({"step": i, "loss": torch.tensor(0.5 * i)})
    assert [r["step"] for r in rec.steps()] == [6, 7, 8, 9]
    b = json.load(open(rec.dump(path=str(tmp_path / "b.json"),
                                reason="unit")))
    assert b["reason"] == "unit" and b["steps"][0]["loss"] == 3.0
    with pytest.raises(ValueError):
        with rec.watch("unit"):
            raise ValueError("boom")
    b = json.load(open(rec.last_dump_path))
    assert b["exception"]["type"] == "ValueError" and len(b["steps"]) == 4
    rec.install(excepthook=False)
    try:
        assert tfr.NANINF_HOOK[0] == rec._on_nan
        tfr.NANINF_HOOK[0]("matmul")   # what a NaN check would call
        assert rec.events()[-1]["kind"] == "naninf"
        assert json.load(open(rec.last_dump_path))["reason"] == \
            "naninf:matmul"
    finally:
        rec.uninstall()
    assert tfr.NANINF_HOOK[0] is None


# -------------------------------------------------------------- step meter
def test_step_meter_flops_mfu_and_geometry(monkeypatch):
    for kw in ({}, {"tie_word_embeddings": True},
               {"num_key_value_heads": 2}):
        jc, tc = JConfig.tiny(**kw), LlamaConfig.tiny(**kw)
        assert obs.analytic_param_count(tc) == \
            jobs.analytic_param_count(jc)
        for seq in (None, 128):
            assert obs.analytic_flops_per_token(tc, seq_len=seq) == \
                jobs.analytic_flops_per_token(jc, seq_len=seq)
    reg = obs.MetricsRegistry()
    meter = obs.StepMeter(registry=reg,
                          recorder=obs.FlightRecorder(registry=reg),
                          flops_per_token=1000.0, peak_flops=1e6)
    meter.observe_step(0.5, examples=4, tokens=256,
                       loss=torch.tensor(1.25))
    assert meter.tokens_per_second.value() == pytest.approx(512.0)
    assert meter.mfu.value() == pytest.approx(512000.0 / 1e6)
    assert meter.loss.value() == 1.25
    meter._last_step_t -= 90  # a 90 s pause: a run break
    meter.observe_step(0.002, examples=4, tokens=256)
    assert meter.tokens_per_second.value() == pytest.approx(512.0)
    assert meter.run_breaks.series() == {(("reason", "unknown"),): 1}
    monkeypatch.delenv("PADDLE_TPU_PEAK_FLOPS", raising=False)
    bare = obs.StepMeter(registry=reg,
                         recorder=obs.FlightRecorder(registry=reg))
    bare.observe_step(0.1, examples=2, tokens=64)
    assert bare.mfu.value() is None  # no card, no peak: unreported
    assert obs.batch_geometry([torch.zeros((4, 16), dtype=torch.long)]) \
        == (4, 64)
    assert obs.batch_geometry([torch.zeros((8, 3, 4, 4))]) == (8, 0)
    assert obs.batch_geometry([np.zeros((4, 16), np.int32)]) == \
        jobs.batch_geometry([np.zeros((4, 16), np.int32)])
    assert obs.device_memory_stats() == {
        "devices": [], "live_array_bytes": 0, "live_array_count": 0}


# -------------------------------------------------------------- trace guard
@pytest.fixture(scope="module")
def net():
    return LlamaForCausalLM(LlamaConfig.tiny(**CFG), device="cpu", seed=5)


def test_guard_storm_fires_past_max_compiles():
    guard = TraceGuard(max_compiles=3)
    fired = []
    guard.on_fire(fired.append)
    for sig in (1, 2, 3, 3, 2):
        assert guard.record_compile("serving::prefill", sig) is None
    f = guard.record_compile("serving::prefill", 4)
    assert f is not None and f.rule == "recompile-storm" and fired == [f]
    assert guard.record_compile("serving::prefill", 5) is None  # once
    assert guard.compile_counts() == {"serving::prefill": 5}
    n = [0]
    guard.watch("serving::decode_step", lambda: n[0])
    n[0] = 4
    assert [x.graph for x in guard.check()] == ["serving::decode_step"]
    guard.reset()
    assert guard.findings == [] and guard.check() == []


@pytest.mark.parametrize("kind", ["slab", "paged", "prefix"])
def test_engines_take_recompile_guard_max_with_jax_default(net, kind):
    """The JAX engines' default bar (``engine.py:257-275``, the prefix
    widening ``paged_engine.py:176-185``), and an explicit one."""
    geom = dict(max_batch_size=2, max_seq_len=64, min_bucket=8)
    extra = {"slab": {}, "paged": {"page_size": 8},
             "prefix": {"page_size": 8, "prefix_cache": True}}[kind]
    port = ServingEngine if kind == "slab" else PagedServingEngine
    eng = port(net, cache_dtype="float32", **geom, **extra)
    buckets = 1 + 6 - 3           # 8, 16, 32, 64
    want = max(4, buckets + 2)
    if kind == "prefix":
        want = max(want, buckets * (buckets + 3) // 2 + 2)
    assert eng.trace_guard.max_compiles == want
    assert port(net, cache_dtype="float32", recompile_guard_max=5, **geom,
                **extra).trace_guard.max_compiles == 5
    for cls in (JSlab, JPaged):  # the parameter is JAX's, with its default
        assert inspect.signature(cls.__init__).parameters[
            "recompile_guard_max"].default is None
    assert inspect.signature(port.__init__).parameters[
        "recompile_guard_max"].default is None
    eng.close()


def test_warmed_paged_engine_records_no_capture_across_traffic(net):
    eng = PagedServingEngine(net, cache_dtype="float32", max_batch_size=2,
                             max_seq_len=64, min_bucket=8, page_size=8,
                             prefix_cache=True)
    fired = []
    eng.trace_guard.on_fire(fired.append)
    eng.warmup()
    before = eng.trace_guard.compile_counts()
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, 64, (n,)) for n in (5, 20, 40, 20)]
    prompts[3][:16] = prompts[1][:16]  # a prefix hit
    hs = [eng.submit(p, 6) for p in prompts]
    eng.run_until_idle()
    assert all(h.status == "DONE" for h in hs)
    assert eng.prefix_cache.hits.value >= 1
    assert eng.trace_guard.compile_counts() == before
    assert sum(before.values()) == sum(eng.compile_counts().values())
    assert fired == [] and eng.metrics.guard_fires.value == 0
    eng.close()


# ------------------------------------------ stores: registry and recorder
def test_stores_publish_and_note_jax_events(tmp_path):
    """One script through the session store and the spill tier of both
    packages, each with a private registry and recorder: the same
    series names in the exposition and the same flight-recorder events,
    in order, with the same fields."""
    def run(o, store_cls, tier_cls):
        reg, t = o.MetricsRegistry(), [0.0]
        rec = o.FlightRecorder(registry=reg)
        st = store_cls(max_sessions=2, ttl_s=5.0, clock=lambda: t[0],
                       registry=reg, recorder=rec)
        for sid in ("a", "b", "c"):
            st.touch(sid)
            st.note_turn(sid, [1, 2, 3])
        t[0] = 10.0
        st.sweep()
        tier = tier_cls(host_budget_bytes=1 << 20, registry=reg,
                        recorder=rec)
        arrays = [np.arange(8, dtype=np.float32)]
        tier.put(("k",), ("p",), [1, 2], 2, arrays, "v0")
        tier.put(("s",), ("p",), [1, 3], 2, arrays, "v0")
        tier.get(("s",), weights_version="v1")   # stale: refused
        tier.get(("k",), weights_version="v0")
        tier.pop(("k",), restored=True)
        names = sorted(obs.parse_prometheus_text(reg.prometheus_text()))
        events = [{k: v for k, v in e.items() if k != "time"}
                  for e in rec.events()]
        return names, events

    assert run(obs, SessionStore, TieredPageStore) == \
        run(jobs, JSessionStore, JTier)


def test_manager_publishes_and_notes_events(tmp_path, net):
    reg = obs.MetricsRegistry()
    rec = obs.FlightRecorder(registry=reg)
    prev = obs.set_flight_recorder(rec)
    try:
        mgr = CheckpointManager(str(tmp_path), network=net,
                                async_saves=False, registry=reg)
        mgr.save(step=1)
        mgr.restore_or_init()
        mgr.close()
    finally:
        obs.set_flight_recorder(prev)
    parsed = obs.parse_prometheus_text(reg.prometheus_text())
    assert parsed["paddle_ckpt_saves_total"] == [({"mode": "sync"}, 1.0)]
    assert parsed["paddle_ckpt_last_step"] == [({}, 1.0)]
    assert [e["kind"] for e in rec.events()] == [
        "checkpoint_commit", "checkpoint_blocked", "checkpoint_restore"]
    assert rec.events()[0]["step"] == 1
