"""SLO classes, per-class attainment, and multi-window burn-rate alerts.

Requests arrive with an ``slo_class`` (``interactive`` by default) whose
latency budgets — TTFT / ITL / E2E at p99 — live in a small process
registry. The serving engines stamp the class onto the existing latency
histograms as a label (resolved ONCE at admission, so the greedy decode
hot loop pays nothing), and :class:`SLOMonitor` turns those cumulative
labeled buckets into the windowed view the control plane needs:

- attainment: the fraction of a class's requests inside budget over a
  window, computed from bucket DELTAS on a :class:`TimeSeriesRing` (a
  cumulative ratio would never recover from a past incident);
- burn rate: ``(1 - attainment) / (1 - target)`` — 1.0 means the error
  budget burns exactly at the sustainable pace, N means N× too fast.
  Each :class:`BurnRateRule` is evaluated on a fast AND a slow window
  (the classic SRE pairing: the fast window catches a sudden breach in
  seconds, the slow window holds the alert through flapping);
- alert fan-out: firing/clearing lands in the flight-recorder event
  ring, a ``paddle_alerts_active{rule,slo_class}`` gauge, and the
  ``/alerts`` endpoints the frontends and fleet router expose.

No wall-clock is read outside ``SLOMonitor(clock=...)`` — tests drive
every window with a fake timer, the same discipline as ``autotune``.
"""

from __future__ import annotations

import math
import threading
import time

from .flight_recorder import get_flight_recorder
from .registry import get_registry
from .timeseries import TimeSeriesRing

DEFAULT_CLASS = "interactive"

_BUDGET_FIELDS = ("ttft", "itl", "e2e")


class UnknownSLOClassError(ValueError):
    """Raised by :meth:`SLORegistry.validate` for a class no one
    registered — the frontend maps it to a 400 at the wire."""


class SLOClass:
    """One named traffic class with p99 latency budgets (seconds) and an
    attainment target (fraction of requests that must be in budget)."""

    __slots__ = ("name", "ttft_p99_s", "itl_p99_s", "e2e_p99_s", "target")

    def __init__(self, name, *, ttft_p99_s, itl_p99_s, e2e_p99_s,
                 target=0.99):
        self.name = str(name)
        self.ttft_p99_s = float(ttft_p99_s)
        self.itl_p99_s = float(itl_p99_s)
        self.e2e_p99_s = float(e2e_p99_s)
        self.target = float(target)
        if not (0.0 < self.target < 1.0):
            raise ValueError(
                f"SLO class {name!r}: target must be in (0, 1), "
                f"got {target}"
            )

    def budget(self, metric):
        """Budget in seconds for ``metric`` in {'ttft','itl','e2e'}."""
        if metric not in _BUDGET_FIELDS:
            raise KeyError(f"unknown SLO metric {metric!r}")
        return getattr(self, f"{metric}_p99_s")

    def to_dict(self):
        return {
            "name": self.name,
            "ttft_p99_s": self.ttft_p99_s,
            "itl_p99_s": self.itl_p99_s,
            "e2e_p99_s": self.e2e_p99_s,
            "target": self.target,
        }

    def __repr__(self):
        return (f"SLOClass({self.name!r}, ttft={self.ttft_p99_s}, "
                f"itl={self.itl_p99_s}, e2e={self.e2e_p99_s}, "
                f"target={self.target})")


def default_classes():
    """The stock traffic classes. Budgets are deliberate, not arbitrary:
    interactive chat needs sub-second first token and smooth streaming;
    RAG tolerates a longer prefill (retrieval-sized prompts); batch is
    throughput-only; agent loops sit between — each turn blocks a tool
    chain, but a human is not watching every token."""
    return [
        SLOClass("interactive", ttft_p99_s=0.5, itl_p99_s=0.1,
                 e2e_p99_s=10.0, target=0.99),
        SLOClass("rag", ttft_p99_s=2.0, itl_p99_s=0.2,
                 e2e_p99_s=30.0, target=0.95),
        SLOClass("batch", ttft_p99_s=30.0, itl_p99_s=1.0,
                 e2e_p99_s=600.0, target=0.90),
        SLOClass("agent", ttft_p99_s=1.0, itl_p99_s=0.15,
                 e2e_p99_s=120.0, target=0.95),
    ]


class SLORegistry:
    """Name -> :class:`SLOClass`. Replace-on-add, like the metrics
    registry."""

    def __init__(self, classes=None):
        self._classes = {}
        self._lock = threading.Lock()
        for c in (default_classes() if classes is None else classes):
            self.add(c)

    def add(self, slo_class):
        with self._lock:
            self._classes[slo_class.name] = slo_class
        return slo_class

    def get(self, name):
        with self._lock:
            return self._classes.get(str(name))

    def names(self):
        with self._lock:
            return sorted(self._classes)

    def __contains__(self, name):
        with self._lock:
            return str(name) in self._classes

    def validate(self, name):
        """Resolve a wire-level class name: ``None``/empty defaults to
        ``interactive``; an unknown name raises
        :class:`UnknownSLOClassError` (the frontend's 400)."""
        if name is None or name == "":
            return DEFAULT_CLASS
        name = str(name)
        with self._lock:
            if name not in self._classes:
                known = ", ".join(sorted(self._classes))
                raise UnknownSLOClassError(
                    f"unknown slo_class {name!r} (known: {known})"
                )
        return name

    def table(self):
        with self._lock:
            return [self._classes[k].to_dict()
                    for k in sorted(self._classes)]


_DEFAULT_SLO = [None]
_DEFAULT_SLO_LOCK = threading.Lock()


def get_slo_registry() -> SLORegistry:
    with _DEFAULT_SLO_LOCK:
        if _DEFAULT_SLO[0] is None:
            _DEFAULT_SLO[0] = SLORegistry()
        return _DEFAULT_SLO[0]


def set_slo_registry(registry):
    """Swap the process-default class registry (tests, smoke gates with
    deliberately tight budgets). Returns the previous one."""
    with _DEFAULT_SLO_LOCK:
        prev, _DEFAULT_SLO[0] = _DEFAULT_SLO[0], registry
    return prev


def within_budget(buckets, budget_s):
    """Estimated count of observations ``<= budget_s`` from cumulative
    ``[{"le": ..., "count": ...}]`` (Prometheus shape, +Inf last).

    Linear interpolation inside the bucket the budget falls in — exact
    at bucket boundaries, and monotone in between. Mass in the +Inf
    overflow bucket counts as BREACHING (conservative: we cannot know
    how far past the last finite bound those requests landed)."""
    budget = float(budget_s)
    prev_le, prev_c = 0.0, 0
    for b in buckets:
        le, c = float(b["le"]), int(b["count"])
        if math.isinf(le):
            # past every finite bound: everything beyond prev_c breaches
            return float(prev_c)
        if budget <= le:
            span = le - prev_le
            frac = 1.0 if span <= 0 else (budget - prev_le) / span
            return prev_c + (c - prev_c) * max(0.0, min(1.0, frac))
        prev_le, prev_c = le, c
    return float(prev_c)


def attainment_report(registry=None, slo_registry=None,
                      namespace="paddle_serving"):
    """Cumulative (whole-process) per-class attainment straight off the
    labeled serving histograms — no ring required. The shape
    ``serve_bench`` embeds as its ``slo`` block:

    ``{cls: {"target": t, "ttft": {"budget_s", "total", "within",
    "breaches", "attainment"}, "itl": {...}, "e2e": {...}}}``"""
    registry = registry or get_registry()
    slo_registry = slo_registry or get_slo_registry()
    out = {}
    for metric in _BUDGET_FIELDS:
        hist = registry.get(f"{namespace}_{metric}_seconds")
        if hist is None:
            continue
        try:
            d = hist.data()
        except Exception:
            continue
        for s in d.get("series") or []:
            cls = s.get("labels", {}).get("slo_class")
            if cls is None:
                continue
            sc = slo_registry.get(cls)
            if sc is None:
                continue
            total = int(s.get("count", 0))
            if total <= 0:
                continue
            ok = within_budget(s["buckets"], sc.budget(metric))
            entry = out.setdefault(cls, {"target": sc.target})
            entry[metric] = {
                "budget_s": sc.budget(metric),
                "total": total,
                "within": ok,
                "breaches": max(0, round(total - ok)),
                "attainment": min(1.0, ok / total),
            }
    return out


class BurnRateRule:
    """One declarative multi-window burn-rate rule over a class/metric.

    Burn rate = ``(1 - attainment) / (1 - target)``. The rule yields two
    sub-alerts, ``<name>:fast`` and ``<name>:slow``: the fast window
    with the higher burn threshold pages quickly on a sudden breach; the
    slow window with burn >= 1 catches a sustained simmer and keeps the
    alert from flapping as the fast window rolls off. ``min_requests``
    suppresses verdicts on windows too thin to mean anything (one slow
    request at 3 a.m. is not an incident)."""

    __slots__ = ("name", "slo_class", "metric", "fast_window_s",
                 "slow_window_s", "fast_burn", "slow_burn",
                 "min_requests", "target")

    def __init__(self, name, slo_class, *, metric="ttft",
                 fast_window_s=60.0, slow_window_s=300.0,
                 fast_burn=2.0, slow_burn=1.0, min_requests=3,
                 target=None):
        if metric not in _BUDGET_FIELDS:
            raise KeyError(f"unknown SLO metric {metric!r}")
        self.name = str(name)
        self.slo_class = str(slo_class)
        self.metric = metric
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.fast_burn = float(fast_burn)
        self.slow_burn = float(slow_burn)
        self.min_requests = int(min_requests)
        self.target = None if target is None else float(target)

    def windows(self):
        return (("fast", self.fast_window_s, self.fast_burn),
                ("slow", self.slow_window_s, self.slow_burn))

    def to_dict(self):
        return {
            "name": self.name, "slo_class": self.slo_class,
            "metric": self.metric,
            "fast_window_s": self.fast_window_s,
            "slow_window_s": self.slow_window_s,
            "fast_burn": self.fast_burn, "slow_burn": self.slow_burn,
            "min_requests": self.min_requests, "target": self.target,
        }


def default_burn_rules(slo_registry=None):
    """One TTFT burn-rate rule per registered class — first-token
    latency is the budget users feel first and the one admission-level
    scheduling can actually move."""
    slo_registry = slo_registry or get_slo_registry()
    return [
        BurnRateRule(f"{name}_ttft", name, metric="ttft")
        for name in slo_registry.names()
    ]


class SLOMonitor:
    """Samples the metrics registry into a :class:`TimeSeriesRing` and
    evaluates burn-rate rules on the windowed deltas.

    Drive it manually with ``sample()`` (tests, deterministic clocks) or
    start the background thread with ``start()``. All alert state
    transitions fan out on the sampling thread: a flight-recorder
    ``note``, the ``paddle_alerts_active`` gauge, and the ``/alerts``
    JSON the frontends serve from :meth:`status`."""

    def __init__(self, registry=None, slo_registry=None, rules=None,
                 interval_s=5.0, capacity=720, clock=time.monotonic,
                 recorder=None, namespace="paddle_serving",
                 gauge_name="paddle_alerts_active"):
        self.registry = registry or get_registry()
        self.slo_registry = slo_registry or get_slo_registry()
        self.rules = list(default_burn_rules(self.slo_registry)
                          if rules is None else rules)
        self.interval_s = float(interval_s)
        self.clock = clock
        self.namespace = namespace
        self.recorder = recorder or get_flight_recorder()
        self.ring = TimeSeriesRing(capacity)
        self.samples_taken = 0
        self._active = {}  # (rule_name, severity) -> alert dict
        self._lock = threading.Lock()
        self._thread = None
        self._stop = threading.Event()
        self._gauge = self.registry.gauge(
            gauge_name,
            help="1 while a burn-rate alert is firing, 0 after it "
                 "clears (labels: rule, slo_class)",
        )
        # newest monitor owns the bundle section (replace-on-register)
        self.recorder.add_section("slo", self._flight_section)

    # ------------------------------------------------------------ sampling
    def _extract(self):
        """One flat sample of every cumulative series the rules need."""
        out = {}
        ns = self.slo_registry
        for metric in _BUDGET_FIELDS:
            hist = self.registry.get(f"{self.namespace}_{metric}_seconds")
            if hist is None:
                continue
            try:
                d = hist.data()
            except Exception:
                continue
            for s in d.get("series") or []:
                cls = s.get("labels", {}).get("slo_class")
                sc = None if cls is None else ns.get(cls)
                if sc is None:
                    continue
                out[f"{metric}.{cls}.total"] = float(s.get("count", 0))
                out[f"{metric}.{cls}.within"] = within_budget(
                    s["buckets"], sc.budget(metric)
                )
        # operational context series the autoscaler will want next to
        # attainment: queue pressure, shed/reject pressure, page misses
        qd = self.registry.get(f"{self.namespace}_queue_depth")
        if qd is not None:
            try:
                out["queue_depth.sum"] = float(qd.sum)
                out["queue_depth.count"] = float(qd.count)
            except Exception:
                pass
        for cname in ("sheds", "rejected"):
            ctr = self.registry.get(f"{self.namespace}_{cname}_total")
            if ctr is None:
                continue
            try:
                d = ctr.data()
            except Exception:
                continue
            out[f"{cname}.total"] = float(d.get("value", 0.0))
            for s in d.get("series") or []:
                for v in s.get("labels", {}).values():
                    out[f"{cname}.{v}"] = float(s.get("value", 0.0))
        return out

    def sample(self, now=None):
        """Take one sample and evaluate every rule. Returns the sample
        dict (handy in tests)."""
        now = self.clock() if now is None else float(now)
        values = self._extract()
        self.ring.append(now, values)
        self.samples_taken += 1
        self._evaluate(now)
        return values

    # ---------------------------------------------------------- attainment
    def attainment(self, slo_class, metric="ttft", window_s=60.0,
                   now=None):
        """Windowed attainment for a class/metric from ring deltas, or
        ``None`` when the window holds no completed requests."""
        total = self.ring.delta(f"{metric}.{slo_class}.total",
                                window_s, now)
        if total <= 0:
            return None
        ok = self.ring.delta(f"{metric}.{slo_class}.within",
                             window_s, now)
        return min(1.0, ok / total)

    def _evaluate(self, now):
        fired, cleared = [], []
        with self._lock:
            for rule in self.rules:
                sc = self.slo_registry.get(rule.slo_class)
                target = rule.target if rule.target is not None else (
                    sc.target if sc is not None else 0.99
                )
                for sev, window_s, burn_thr in rule.windows():
                    total = self.ring.delta(
                        f"{rule.metric}.{rule.slo_class}.total",
                        window_s, now,
                    )
                    att = self.attainment(rule.slo_class, rule.metric,
                                          window_s, now)
                    firing = False
                    burn = None
                    if att is not None and total >= rule.min_requests:
                        burn = (1.0 - att) / max(1e-9, 1.0 - target)
                        firing = burn >= burn_thr
                    key = (rule.name, sev)
                    cur = self._active.get(key)
                    if firing and cur is None:
                        alert = {
                            "rule": f"{rule.name}:{sev}",
                            "slo_class": rule.slo_class,
                            "metric": rule.metric,
                            "severity": sev,
                            "window_s": window_s,
                            "burn": burn,
                            "burn_threshold": burn_thr,
                            "attainment": att,
                            "target": target,
                            "since": now,
                        }
                        self._active[key] = alert
                        fired.append(alert)
                    elif firing and cur is not None:
                        cur.update(burn=burn, attainment=att)
                    elif not firing and cur is not None:
                        cleared.append(self._active.pop(key))
        for alert in fired:
            self._gauge.set(1, rule=alert["rule"],
                            slo_class=alert["slo_class"])
            self.recorder.note("slo_alert", **alert)
        for alert in cleared:
            self._gauge.set(0, rule=alert["rule"],
                            slo_class=alert["slo_class"])
            self.recorder.note("slo_alert_cleared", rule=alert["rule"],
                               slo_class=alert["slo_class"])

    # ------------------------------------------------------------- readout
    def active_alerts(self):
        with self._lock:
            return sorted((dict(a) for a in self._active.values()),
                          key=lambda a: a["rule"])

    def alerts_block(self):
        """The compact block ``/healthz`` embeds (what the fleet router
        scrapes): active alerts plus enough context to aggregate."""
        active = self.active_alerts()
        return {
            "active": active,
            "count": len(active),
            "samples": self.samples_taken,
            "interval_s": self.interval_s,
        }

    def status(self):
        """Full ``/alerts`` payload: active alerts, rule table, class
        table, and current fast/slow attainment per rule."""
        att = {}
        for rule in self.rules:
            e = att.setdefault(rule.slo_class, {})
            for sev, window_s, _ in rule.windows():
                e[f"{rule.metric}_{sev}"] = {
                    "window_s": window_s,
                    "attainment": self.attainment(
                        rule.slo_class, rule.metric, window_s
                    ),
                }
        return {
            "alerts": self.active_alerts(),
            "rules": [r.to_dict() for r in self.rules],
            "classes": self.slo_registry.table(),
            "attainment": att,
            "samples": self.samples_taken,
        }

    def _flight_section(self, k=8):
        return {
            "active_alerts": self.active_alerts(),
            "window_samples": [
                {"t": t, "values": v} for t, v in self.ring.last(k)
            ],
        }

    # ----------------------------------------------------------- lifecycle
    def start(self):
        """Start the background sampling thread (daemon; idempotent)."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()

        def _loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.sample()
                except Exception:  # pragma: no cover - defensive
                    pass  # the monitor must never take the server down

        self._thread = threading.Thread(
            target=_loop, name="slo-monitor", daemon=True
        )
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2.0)
