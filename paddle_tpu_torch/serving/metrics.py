"""Serving metrics: registry-based counters + histograms (the port of
``paddle_tpu/serving/metrics.py``).

The serving quantities users actually page on — queue depth,
time-to-first-token, inter-token latency, slot occupancy, rejection and
timeout counts — live here as plain host-side counters/histograms (no
device work; observing a sample is a list append). They are thin
subclasses of the process-wide ``paddle_tpu_torch.observability``
instruments: every ServingMetrics registers its set under
``paddle_serving_*`` names in the global registry (replace-on-register —
the newest engine's metrics own the series), so one Prometheus scrape
covers serving alongside training and analysis telemetry. JAX also
forwards every histogram sample to ``profiler.record_span``; that waits
with the profiler (``ROADMAP.md`` queue A item 7).
"""
from __future__ import annotations

from ..observability import registry as _reg
from ..observability.registry import Gauge  # noqa: F401  (re-exported)


class Counter(_reg.Counter):
    """Monotonic counter (optionally labeled by a reason string).

    The serving-side convenience shape over the registry Counter: one
    optional label dimension (``labelname``), ``by_label()`` readout."""

    def __init__(self, name, labelname="label", prom_name=None, help=""):
        super().__init__(name, help=help, prom_name=prom_name)
        self._labelname = labelname

    def inc(self, n=1, label=None, trace_id=None, **labels):
        """``label=`` is the serving shorthand for the configured
        labelname; registry-style ``**labels`` kwargs (what the
        inherited ``.labels()`` binding forwards) pass straight
        through, so both idioms work on the same instrument.
        ``trace_id`` records an exemplar on the bumped series."""
        if label is not None:
            labels[self._labelname] = label
        super().inc(n, trace_id=trace_id, **labels)

    def by_label(self):
        out = {}
        for k, v in self.series().items():
            d = dict(k)
            if self._labelname in d:
                out[d[self._labelname]] = \
                    out.get(d[self._labelname], 0) + v
        return out


class Histogram(_reg.Histogram):
    """Sample store with percentile readout.

    Memory-bounded for long-running servers: the window keeps the most
    recent ``maxlen`` samples (sliding-window percentiles — what a
    latency dashboard wants anyway), while ``count``/``sum``/Prometheus
    buckets stay exact running totals over ALL observations.
    ``snapshot()['mean']`` is the exact running ``sum/count``;
    p50/p90/p99/min/max describe only the window —
    ``snapshot()['window_count']`` tells dashboards how big that window
    population is (see the base class docstring for the full split)."""

    def __init__(self, name, unit="s", maxlen=65536,
                 prom_name=None, buckets=None, help=""):
        if buckets is None:
            buckets = (_reg.DEFAULT_BUCKETS if unit == "s"
                       else _reg.COUNT_BUCKETS)
        super().__init__(name, help=help, unit=unit, maxlen=maxlen,
                         buckets=buckets, prom_name=prom_name)


class ServingMetrics:
    """The engine's metric set. One instance per engine (or share one
    across engines to aggregate a process). Registered in the process
    registry under ``<namespace>_*`` with replace semantics: the most
    recently constructed instance owns the exported series.

    Besides the JAX package's set the port times every prefill
    (``prefill_time``) and every decode step (``decode_step_time``),
    host clock around work that ends in a device read-back, so
    throughput can be read per phase, the prefills of prefix-cache hits
    on their own (``warm_prefill_time``: gather, chunk prefill and adopt;
    they are in ``prefill_time`` too), and counts decode tokens
    (``decode_tokens``)."""

    def __init__(self, registry=None, namespace="paddle_serving"):
        ns = namespace
        self.submitted = Counter(
            "submitted", prom_name=f"{ns}_submitted_total",
            help="requests submitted")
        self.admitted = Counter(
            "admitted", prom_name=f"{ns}_admitted_total",
            help="requests admitted into the decode slab")
        self.completed = Counter(
            "completed", prom_name=f"{ns}_completed_total",
            help="requests finished DONE")
        self.rejected = Counter(          # labeled by reason
            "rejected", labelname="reason",
            prom_name=f"{ns}_rejected_total",
            help="requests rejected, by reason")
        self.timeouts = Counter(
            "timeouts", prom_name=f"{ns}_timeouts_total",
            help="requests expired past their deadline")
        self.sheds = Counter(             # labeled by reason
            "sheds", labelname="reason",
            prom_name=f"{ns}_sheds_total",
            help="in-flight requests shed by the engine, by reason "
                 "(pages_exhausted = a demand-grown decode page claim "
                 "that eviction could not satisfy)")
        self.tokens_out = Counter(
            "tokens_out", prom_name=f"{ns}_tokens_out_total",
            help="decode tokens emitted")
        self.prefill_tokens = Counter(
            "prefill_tokens", prom_name=f"{ns}_prefill_tokens_total",
            help="prompt tokens prefilled")
        self.decode_tokens = Counter(
            "decode_tokens", prom_name=f"{ns}_decode_tokens_total",
            help="tokens emitted by decode steps or speculative rounds")
        self.guard_fires = Counter(       # labeled by fn key
            "guard_fires", labelname="fn",
            prom_name=f"{ns}_guard_fires_total",
            help="trace-guard recompile-storm fires seen by the engine")
        self.reloads = Counter(           # labeled by outcome
            "reloads", labelname="outcome",
            prom_name=f"{ns}_reloads_total",
            help="live weight reloads, by outcome (ok|verify_failed|"
                 "load_error|incompatible|error|...)")
        self.reload_ttft_spike = Histogram(
            "reload_ttft_spike",
            prom_name=f"{ns}_reload_ttft_spike_seconds",
            help="admission pause of one live reload (staged -> "
                 "applied): the worst-case extra TTFT a request queued "
                 "during the swap window saw")
        self.ttft = Histogram(            # submit -> first token
            "ttft", prom_name=f"{ns}_ttft_seconds",
            help="time to first token")
        self.itl = Histogram(             # inter-token latency
            "itl", prom_name=f"{ns}_itl_seconds",
            help="inter-token latency")
        self.e2e = Histogram(             # submit -> finished
            "e2e", prom_name=f"{ns}_e2e_seconds",
            help="end-to-end request latency")
        self.queue_wait = Histogram(      # submit -> admitted
            "queue_wait", prom_name=f"{ns}_queue_wait_seconds",
            help="queue wait before admission")
        self.prefill_time = Histogram(
            "prefill_time", prom_name=f"{ns}_prefill_time_seconds",
            help="one admission's prefill and adopt (host clock, ends in "
                 "the first token's read-back)")
        self.warm_prefill_time = Histogram(
            "warm_prefill_time",
            prom_name=f"{ns}_warm_prefill_time_seconds",
            help="prefix-cache hits' prefills (gather, chunk prefill, "
                 "adopt)")
        self.decode_step_time = Histogram(
            "decode_step_time",
            prom_name=f"{ns}_decode_step_time_seconds",
            help="one decode step or speculative round (host clock, "
                 "ends in the tokens' read-back)")
        self.queue_depth = Histogram(
            "queue_depth", unit="reqs",
            prom_name=f"{ns}_queue_depth",
            help="scheduler queue depth sampled per engine step")
        self.slot_occupancy = Histogram(
            "slot_occupancy", unit="slots",
            prom_name=f"{ns}_slot_occupancy",
            help="active decode-slab slots sampled per engine step")
        # speculative decoding (serving.speculative): one round = one
        # draft proposal pass + one target verify launch
        self.spec_rounds = Counter(
            "speculative_rounds",
            prom_name=f"{ns}_speculative_rounds_total",
            help="speculative propose+verify rounds run")
        self.spec_proposed = Counter(
            "speculative_proposed_tokens",
            prom_name=f"{ns}_speculative_proposed_tokens_total",
            help="draft tokens proposed to the verifier")
        self.spec_accepted = Counter(
            "speculative_accepted_tokens",
            prom_name=f"{ns}_speculative_accepted_tokens_total",
            help="draft tokens the verifier accepted")
        self.spec_accept_length = Histogram(
            "speculative_accept_length", unit="toks",
            prom_name=f"{ns}_speculative_accept_length",
            help="tokens emitted per speculative round (accepted "
                 "prefix + the correction/bonus token; mean > 1 is "
                 "the whole win)")
        reg = registry
        if reg is None:
            from ..observability import get_registry

            reg = get_registry()
        reg.register_all([
            self.submitted, self.admitted, self.completed, self.rejected,
            self.timeouts, self.sheds, self.tokens_out,
            self.prefill_tokens, self.decode_tokens,
            self.prefill_time, self.warm_prefill_time,
            self.decode_step_time,
            self.guard_fires, self.reloads, self.reload_ttft_spike,
            self.ttft, self.itl, self.e2e,
            self.queue_wait, self.queue_depth, self.slot_occupancy,
            self.spec_rounds, self.spec_proposed, self.spec_accepted,
            self.spec_accept_length,
        ])
        # slo_class -> (ttft_child, itl_child, e2e_child). Lives on the
        # metrics OBJECT (not the engine) so the cache dies with the
        # instrument it binds to — serve_bench swaps engine.metrics
        # wholesale after warmup, and a cache held elsewhere would keep
        # observing into the discarded histograms.
        self._slo_children = {}

    def slo_children(self, slo_class):
        """Per-class bound children of the latency histograms, resolved
        once per class per metrics instance. Called at ADMISSION only;
        the returned bindings are what the hot loops observe into, so
        the per-token path never touches a label dict."""
        ch = self._slo_children.get(slo_class)
        if ch is None:
            ch = (
                self.ttft.labels(slo_class=slo_class),
                self.itl.labels(slo_class=slo_class),
                self.e2e.labels(slo_class=slo_class),
            )
            self._slo_children[slo_class] = ch
        return ch

    def observe_step(self, queue_depth, active_slots):
        self.queue_depth.observe(queue_depth)
        self.slot_occupancy.observe(active_slots)

    def report(self):
        """Plain-dict snapshot (what serve_bench prints as JSON)."""
        return {
            "counters": {
                "submitted": self.submitted.value,
                "admitted": self.admitted.value,
                "completed": self.completed.value,
                "rejected": self.rejected.value,
                "rejected_by_reason": self.rejected.by_label(),
                "timeouts": self.timeouts.value,
                "sheds": self.sheds.value,
                "sheds_by_reason": self.sheds.by_label(),
                "tokens_out": self.tokens_out.value,
                "prefill_tokens": self.prefill_tokens.value,
                "decode_tokens": self.decode_tokens.value,
                "guard_fires": self.guard_fires.value,
                "guard_fires_by_fn": self.guard_fires.by_label(),
                "reloads": self.reloads.value,
                "reloads_by_outcome": self.reloads.by_label(),
                "speculative_rounds": self.spec_rounds.value,
                "speculative_proposed": self.spec_proposed.value,
                "speculative_accepted": self.spec_accepted.value,
            },
            "speculative_accept_length":
                self.spec_accept_length.snapshot(),
            "reload_ttft_spike": self.reload_ttft_spike.snapshot(),
            "ttft": self.ttft.snapshot(),
            "itl": self.itl.snapshot(),
            "e2e": self.e2e.snapshot(),
            "queue_wait": self.queue_wait.snapshot(),
            "prefill_time": self.prefill_time.snapshot(),
            "warm_prefill_time": self.warm_prefill_time.snapshot(),
            "decode_step_time": self.decode_step_time.snapshot(),
            "queue_depth": self.queue_depth.snapshot(),
            "slot_occupancy": self.slot_occupancy.snapshot(),
        }
