"""Serving metrics: host-side counters and latency histograms
(counterpart of ``paddle_tpu/serving/metrics.py``).

The JAX package registers these in a process-wide Prometheus registry;
that registry is not ported, so the port keeps its own small Counter,
Gauge and Histogram with the same reading surface (``value``,
``by_label()``, ``set()``, ``count``, ``snapshot()``). Observing a
sample is a list append; nothing here touches the device.
"""
from __future__ import annotations

import collections
import math


class Counter:
    """Monotonic counter, optionally split by one label."""

    def __init__(self, name):
        self.name = name
        self.value = 0
        self._by_label = collections.Counter()

    def inc(self, n=1, label=None):
        self.value += n
        if label is not None:
            self._by_label[label] += n

    def by_label(self):
        return dict(self._by_label)


class Gauge:
    """A value that is set, not accumulated (the prefix cache's shared
    bytes saved), optionally one a label (the spill tier's pages per
    tier)."""

    def __init__(self, name):
        self.name = name
        self.value = 0.0
        self._by_label = {}

    def set(self, v, label=None):
        if label is None:
            self.value = float(v)
        else:
            self._by_label[label] = float(v)

    def by_label(self):
        return dict(self._by_label)


class Histogram:
    """Samples with percentile readout over a sliding window of the
    latest ``maxlen`` observations; ``count`` and ``sum`` are exact
    totals over all of them."""

    def __init__(self, name, unit="s", maxlen=65536):
        self.name = name
        self.unit = unit
        self.count = 0
        self.sum = 0.0
        self._samples = collections.deque(maxlen=maxlen)

    def observe(self, v):
        v = float(v)
        self.count += 1
        self.sum += v
        self._samples.append(v)

    def percentile(self, q):
        """Nearest-rank percentile ``q`` in [0, 100] of the window."""
        if not self._samples:
            return None
        s = sorted(self._samples)
        k = max(0, min(len(s) - 1, math.ceil(q / 100.0 * len(s)) - 1))
        return s[k]

    def snapshot(self):
        if not self._samples:
            return {"count": self.count, "unit": self.unit}
        return {
            "count": self.count,
            "window_count": len(self._samples),
            "unit": self.unit,
            "mean": self.sum / self.count,
            "min": min(self._samples),
            "max": max(self._samples),
            "p50": self.percentile(50),
            "p90": self.percentile(90),
            "p99": self.percentile(99),
        }


class ServingMetrics:
    """The engine's metric set, one instance per engine. Besides the
    JAX package's set it times every prefill (``prefill_time``) and
    every decode step (``decode_step_time``), host clock around work
    that ends in a device sync, so throughput can be read per phase, and
    the prefills of prefix-cache hits on their own
    (``warm_prefill_time``: gather, chunk prefill and adopt; they are in
    ``prefill_time`` too)."""

    def __init__(self):
        self.submitted = Counter("submitted")
        self.admitted = Counter("admitted")
        self.completed = Counter("completed")
        self.rejected = Counter("rejected")       # by reason
        self.timeouts = Counter("timeouts")
        self.sheds = Counter("sheds")             # by reason
        self.tokens_out = Counter("tokens_out")
        self.prefill_tokens = Counter("prefill_tokens")
        self.decode_tokens = Counter("decode_tokens")
        self.ttft = Histogram("ttft")             # submit -> first token
        self.itl = Histogram("itl")               # inter-token latency
        self.e2e = Histogram("e2e")               # submit -> finished
        self.queue_wait = Histogram("queue_wait")  # submit -> admitted
        self.prefill_time = Histogram("prefill_time")
        self.warm_prefill_time = Histogram("warm_prefill_time")
        self.decode_step_time = Histogram("decode_step_time")
        self.queue_depth = Histogram("queue_depth", unit="reqs")
        self.slot_occupancy = Histogram("slot_occupancy", unit="slots")
        # speculative decoding (speculative.py): one round is one draft
        # proposal pass and one target verify launch
        self.spec_rounds = Counter("speculative_rounds")
        self.spec_proposed = Counter("speculative_proposed_tokens")
        self.spec_accepted = Counter("speculative_accepted_tokens")
        # tokens emitted a round: the accepted prefix and the correction
        # or bonus token (a mean above 1 is the whole win)
        self.spec_accept_length = Histogram("speculative_accept_length",
                                            unit="toks")
        # live reload (reload.py): outcomes by label (ok, verify_failed,
        # load_error, incompatible, no_checkpoint, error, superseded,
        # abandoned, engine_closed), and each swap's admission pause
        # (staged -> applied): the worst extra TTFT a queued request saw
        self.reloads = Counter("reloads")
        self.reload_ttft_spike = Histogram("reload_ttft_spike")

    def observe_step(self, queue_depth, active_slots):
        self.queue_depth.observe(queue_depth)
        self.slot_occupancy.observe(active_slots)

    def report(self):
        counters = {
            name: getattr(self, name).value
            for name in ("submitted", "admitted", "completed", "rejected",
                         "timeouts", "sheds", "tokens_out",
                         "prefill_tokens", "decode_tokens")
        }
        counters["rejected_by_reason"] = self.rejected.by_label()
        counters["sheds_by_reason"] = self.sheds.by_label()
        counters["speculative_rounds"] = self.spec_rounds.value
        counters["speculative_proposed"] = self.spec_proposed.value
        counters["speculative_accepted"] = self.spec_accepted.value
        counters["reloads"] = self.reloads.value
        counters["reloads_by_outcome"] = self.reloads.by_label()
        out = {"counters": counters,
               "speculative_accept_length":
                   self.spec_accept_length.snapshot()}
        for name in ("ttft", "itl", "e2e", "queue_wait", "prefill_time",
                     "warm_prefill_time", "decode_step_time", "queue_depth",
                     "slot_occupancy", "reload_ttft_spike"):
            out[name] = getattr(self, name).snapshot()
        return out
