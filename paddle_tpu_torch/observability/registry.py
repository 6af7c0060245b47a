"""Process-wide metrics registry: Counter / Gauge / Histogram with labels.

Every observability surface the repo has grown — serving's
TTFT/ITL/queue counters, the trace guard's recompile-storm fires, the
profiler's lint-event counts, and (new) training-step telemetry — used
to keep private state with private readouts. This module is the one
place they all publish into: a named instrument registers itself in a
:class:`MetricsRegistry` and every consumer (the Prometheus text
exporter, the JSON snapshot, the /metrics HTTP endpoint, the flight
recorder's crash bundle, the multihost merge) reads the same registry.

Design constraints, in order:

- **Never on the device.** Observing is a host-side integer/float
  update under a lock. Gauges may hold a CALLABLE (or a device
  scalar) that is materialized only when somebody scrapes — the fit hot
  loop must not synchronize with the device per step (hapi's lazy-logs
  rule applies here too).
- **Bounded memory.** Counters/gauges are O(label cardinality);
  histograms keep a fixed running bucket vector plus a bounded sliding
  sample window (see :class:`Histogram` for the mean-vs-percentile
  window split).
- **Replace-on-register.** Re-constructing an instrument set (a fresh
  ``ServingMetrics`` per engine, a bench resetting after warmup)
  re-registers under the same name and REPLACES the previous series —
  the registry always reflects the newest owner, and tests stay
  isolated without global resets.

The PyTorch port's copy of ``paddle_tpu/observability/registry.py``.
One change: a lazy gauge value may be a CUDA tensor where JAX holds a
jax array. ``Gauge.set`` wraps such a tensor in a :class:`DeviceValue`
that records a CUDA event on the current stream when it is set;
``value_is_ready`` queries that event (never a synchronization), and
``_materialize`` reads the value with ``.item()``. JAX's ``Histogram``
of the serving metrics also forwards every sample to
``profiler.record_span``; the profiler is not ported (``ROADMAP.md``
queue A item 7), so the port's histograms forward nothing yet.
"""
from __future__ import annotations

import bisect
import collections
import threading

# latency-shaped default buckets (seconds)
DEFAULT_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)
# count-shaped buckets (queue depths, slot occupancy)
COUNT_BUCKETS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0,
                 256.0, 1024.0)
# token-batch-shaped buckets: B*S for real LLM steps runs well past 4k
# (the repo's own perf config is 4x1024); powers of four up to ~1M
TOKEN_BUCKETS = (16.0, 64.0, 256.0, 1024.0, 4096.0, 16384.0, 65536.0,
                 262144.0, 1048576.0)


def _labels_key(labels):
    return tuple(sorted(labels.items()))


class _Metric:
    """Shared identity: ``name`` is the short/display name, ``prom_name``
    the canonical registry + Prometheus series name."""

    metric_type = "untyped"

    def __init__(self, name, help="", unit="", prom_name=None):
        self.name = name
        self.prom_name = prom_name or name
        self.help = help
        self.unit = unit
        self._lock = threading.Lock()


class Counter(_Metric):
    """Monotonic counter with an optional label breakdown.

    ``inc(n, **labels)`` always bumps the unlabeled total; when labels
    are given the matching child series is bumped as well, so the total
    never needs a sum over children at read time."""

    metric_type = "counter"

    def __init__(self, name, help="", unit="", prom_name=None):
        super().__init__(name, help=help, unit=unit, prom_name=prom_name)
        self._value = 0
        self._series = {}
        # bounded per-series exemplar: the LAST trace_id whose request
        # bumped this series (labels_key -> {"trace_id", "value"}) —
        # same cardinality bound as the series map itself
        self._exemplars = {}

    def inc(self, n=1, trace_id=None, **labels):
        with self._lock:
            self._value += n
            k = _labels_key(labels)
            if labels:
                self._series[k] = self._series.get(k, 0) + n
            if trace_id is not None:
                self._exemplars[k] = {
                    "trace_id": str(trace_id), "value": float(n),
                }

    def labels(self, **labels):
        counter = self

        class _Bound:
            def inc(self, n=1, trace_id=None):
                counter.inc(n, trace_id=trace_id, **labels)

        return _Bound()

    @property
    def value(self):
        return self._value

    def series(self):
        with self._lock:
            return dict(self._series)

    def exemplars(self):
        """labels_key -> {"trace_id", "value"} (copies)."""
        with self._lock:
            return {k: dict(v) for k, v in self._exemplars.items()}

    def data(self):
        with self._lock:
            out = {
                "type": self.metric_type,
                "value": self._value,
                "series": [
                    dict(
                        {"labels": dict(k), "value": v},
                        **({"exemplar": dict(self._exemplars[k])}
                           if k in self._exemplars else {}),
                    )
                    for k, v in self._series.items()
                ],
            }
            ex = self._exemplars.get(())
            if ex is not None:
                out["exemplar"] = dict(ex)
            return out


_NONBLOCK = threading.local()


def nonblocking_active():
    """True inside a :class:`nonblocking_values` context (the one
    public check — callers must not reach into the thread-local)."""
    return getattr(_NONBLOCK, "on", False)


class nonblocking_values:
    """Context: lazy-value materialization must not block.

    A crash dump fired from inside a NaN hook runs WHILE the step's
    work is still queued on the device; fetching a device value of that
    very computation would block the dump on it. Inside this context, values whose ``is_ready()`` reports
    false are skipped (gauges) or repr'd (flight records) rather than
    fetched. Thread-local, so a concurrent normal scrape on another
    thread keeps its blocking lazy semantics."""

    def __enter__(self):
        self._prev = getattr(_NONBLOCK, "on", False)
        _NONBLOCK.on = True
        return self

    def __exit__(self, *exc):
        _NONBLOCK.on = self._prev
        return False


class DeviceValue:
    """A CUDA tensor held as a lazy gauge value, with the CUDA event
    recorded on the current stream when it was set: ``is_ready()``
    queries the event (it never waits), ``float()`` reads the tensor
    with ``.item()`` (which waits for it). ``event`` may be any object
    with an event's ``query()``."""

    __slots__ = ("tensor", "event")

    def __init__(self, tensor, event=None):
        if event is None:
            import torch

            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(tensor.device))
        self.tensor = tensor
        self.event = event

    def is_ready(self):
        return bool(self.event.query())

    def __float__(self):
        return float(self.tensor.item())

    def __repr__(self):
        return f"DeviceValue({self.tensor!r})"


def device_value(v):
    """``v`` wrapped in a :class:`DeviceValue` when it is a CUDA tensor,
    else ``v`` unchanged."""
    if getattr(v, "is_cuda", False) and hasattr(v, "item"):
        return DeviceValue(v)
    return v


def value_is_ready(v):
    """False only when ``v`` is an in-flight device value (a
    :class:`DeviceValue` whose event has not completed); anything else
    counts as ready."""
    ready = getattr(v, "is_ready", None)
    if callable(ready):
        try:
            return bool(ready())
        except Exception:
            return True
    return True


def _materialize(v):
    """Resolve a lazy gauge value: callables are invoked, device scalars
    fetched — only ever on the scrape path, never per step. Under
    :class:`nonblocking_values`, an in-flight device value raises
    instead of blocking (the caller skips the series)."""
    if callable(v):
        v = v()
    if nonblocking_active() and not value_is_ready(v):
        raise ValueError("device value still in flight "
                         "(nonblocking scrape)")
    item = getattr(v, "item", None)
    if callable(item):
        return float(item())
    try:
        return float(v)
    except (TypeError, ValueError):
        import numpy as np

        return float(np.asarray(v))


class Gauge(_Metric):
    """Last-value instrument. ``set`` accepts a float, a callable, or a
    device scalar; lazy values materialize on scrape (snapshot /
    Prometheus render), keeping the training hot loop sync-free."""

    metric_type = "gauge"

    def __init__(self, name, help="", unit="", prom_name=None):
        super().__init__(name, help=help, unit=unit, prom_name=prom_name)
        self._series = {}  # labels_key -> value | callable | device ref

    def set(self, value, **labels):
        value = device_value(value)
        with self._lock:
            self._series[_labels_key(labels)] = value

    def set_function(self, fn, **labels):
        self.set(fn, **labels)

    def inc(self, n=1.0, **labels):
        with self._lock:
            k = _labels_key(labels)
            cur = self._series.get(k, 0.0)
            if callable(cur):
                raise TypeError(f"gauge {self.name}: inc() on a lazy value")
            self._series[k] = cur + n

    def dec(self, n=1.0, **labels):
        self.inc(-n, **labels)

    def value(self, **labels):
        with self._lock:
            v = self._series.get(_labels_key(labels))
        return None if v is None else _materialize(v)

    def data(self):
        with self._lock:
            items = list(self._series.items())
        series = []
        for k, v in items:
            try:
                series.append({"labels": dict(k), "value": _materialize(v)})
            except Exception:
                continue  # a lazy value that cannot resolve is skipped
        return {"type": self.metric_type, "series": series}


class _HistogramChild:
    """Per-label-set running state of a labeled :class:`Histogram`
    (cumulative count/sum/buckets plus a small sliding window for
    per-label percentiles). Mutated only under the parent's lock."""

    __slots__ = ("count", "sum", "bucket_counts", "exemplars", "window")

    def __init__(self, nslots, window_maxlen):
        self.count = 0
        self.sum = 0.0
        self.bucket_counts = [0] * nslots
        self.exemplars = [None] * nslots
        self.window = collections.deque(maxlen=int(window_maxlen))


class _BoundHistogram:
    """``hist.labels(...)`` binding: observe() lands on BOTH the parent
    aggregate and the labeled child, under one lock acquisition. Bind
    once (e.g. at request admission) and the hot loop pays exactly the
    unlabeled observe() cost — no per-sample label-dict allocation."""

    __slots__ = ("_hist", "_key")

    def __init__(self, hist, key):
        self._hist = hist
        self._key = key

    def observe(self, v, trace_id=None):
        self._hist.observe(v, trace_id=trace_id, labels_key=self._key)


class Histogram(_Metric):
    """Sample distribution with bounded memory.

    Two views, deliberately different windows:

    - ``count`` / ``sum`` / Prometheus bucket counts are EXACT running
      totals over every observation ever made (what rate() and mean
      dashboards need);
    - percentiles (``percentile``, ``snapshot()['p50']``...) are
      computed over a SLIDING WINDOW of the most recent ``maxlen``
      samples (what a latency dashboard wants, and the only way to keep
      a long-running server's memory bounded).

    ``snapshot()['mean']`` is therefore ``sum/count`` over ALL
    observations while p50/p90/p99/min/max describe only the window;
    ``snapshot()['window_count']`` says how many samples the window
    currently holds so dashboards can tell the two populations apart.

    Label support mirrors :class:`Counter`: ``labels(**labels)`` returns
    a bound child whose ``observe`` updates the parent aggregate AND the
    child's own cumulative count/sum/buckets (one lock acquisition), so
    the unlabeled totals never need a sum over children at read time and
    a mixed family stays double-count-free in the exposition (children +
    blank-label remainder)."""

    metric_type = "histogram"

    def __init__(self, name, help="", unit="s", maxlen=65536,
                 buckets=None, prom_name=None, child_window=4096):
        super().__init__(name, help=help, unit=unit, prom_name=prom_name)
        self._samples = collections.deque(maxlen=int(maxlen))
        self._count = 0
        self._sum = 0.0
        self.buckets = tuple(sorted(buckets or DEFAULT_BUCKETS))
        # per-bucket (non-cumulative) counts; last slot is +Inf overflow
        self._bucket_counts = [0] * (len(self.buckets) + 1)
        # bounded per-bucket exemplar: the LAST trace_id observed into
        # each bucket slot (None until one arrives) — links a latency
        # bucket straight to a representative distributed trace
        self._exemplars = [None] * (len(self.buckets) + 1)
        # labels_key -> _HistogramChild; bounded by label cardinality
        # (slo_class is a small closed set)
        self._children = {}
        self._child_window = int(child_window)

    def labels(self, **labels):
        """A bound child for ``labels`` (the parent itself when empty).
        Resolving allocates; the returned binding's observe() does not —
        resolve once at admission, observe per token."""
        if not labels:
            return self
        key = _labels_key(labels)
        with self._lock:
            if key not in self._children:
                self._children[key] = _HistogramChild(
                    len(self._bucket_counts), self._child_window
                )
        return _BoundHistogram(self, key)

    def observe(self, v, trace_id=None, labels_key=None):
        v = float(v)
        with self._lock:
            self._samples.append(v)
            self._count += 1
            self._sum += v
            idx = bisect.bisect_left(self.buckets, v)
            self._bucket_counts[idx] += 1
            if trace_id is not None:
                self._exemplars[idx] = {
                    "trace_id": str(trace_id), "value": v,
                }
            if labels_key is not None:
                ch = self._children.get(labels_key)
                if ch is None:
                    ch = self._children[labels_key] = _HistogramChild(
                        len(self._bucket_counts), self._child_window
                    )
                ch.count += 1
                ch.sum += v
                ch.bucket_counts[idx] += 1
                ch.window.append(v)
                if trace_id is not None:
                    ch.exemplars[idx] = {
                        "trace_id": str(trace_id), "value": v,
                    }

    @property
    def count(self):
        return self._count

    @property
    def sum(self):
        return self._sum

    @property
    def window_count(self):
        return len(self._samples)

    def percentile(self, p):
        """p in [0, 100]; nearest-rank over the sliding window. None
        when empty."""
        with self._lock:
            if not self._samples:
                return None
            s = sorted(self._samples)
        k = max(0, min(len(s) - 1, int(round(p / 100.0 * (len(s) - 1)))))
        return s[k]

    def cumulative_buckets(self):
        """[(upper_bound, cumulative_count)] over ALL observations, with
        a final (inf, count) entry — the Prometheus exposition shape."""
        with self._lock:
            counts = list(self._bucket_counts)
        out, acc = [], 0
        for ub, c in zip(self.buckets, counts):
            acc += c
            out.append((ub, acc))
        out.append((float("inf"), acc + counts[-1]))
        return out

    def snapshot(self):
        """Plain-dict readout.

        WINDOW SPLIT (read this before graphing): ``count``/``sum``/
        ``mean`` are exact running totals over every observation;
        ``p50``/``p90``/``p99``/``min``/``max`` describe only the most
        recent ``window_count`` samples. With fewer than ``maxlen``
        total observations the two populations coincide."""
        with self._lock:
            if not self._samples:
                return {"count": self._count, "window_count": 0}
            window = sorted(self._samples)
            count, total = self._count, self._sum

        def pct(p):
            k = max(0, min(len(window) - 1,
                           int(round(p / 100.0 * (len(window) - 1)))))
            return window[k]

        return {
            "count": count,
            "sum": total,
            "mean": total / count,
            "window_count": len(window),
            "p50": pct(50),
            "p90": pct(90),
            "p99": pct(99),
            "max": window[-1],
            "min": window[0],
            "unit": self.unit,
        }

    def data(self):
        # ONE lock acquisition for window + totals + bucket counts: a
        # concurrent observe between two reads would otherwise emit an
        # exposition where _count disagrees with the +Inf bucket
        # (Prometheus invariant: count == cumulative +Inf)
        with self._lock:
            window = sorted(self._samples)
            count, total = self._count, self._sum
            counts = list(self._bucket_counts)
            exemplars = [
                None if e is None else dict(e) for e in self._exemplars
            ]
            children = [
                (key, ch.count, ch.sum, list(ch.bucket_counts),
                 [None if e is None else dict(e) for e in ch.exemplars],
                 sorted(ch.window))
                for key, ch in self._children.items()
            ]
        d = {"type": self.metric_type, "count": count,
             "window_count": len(window)}
        if window:
            def pct(p):
                k = max(0, min(len(window) - 1,
                               int(round(p / 100.0 * (len(window) - 1)))))
                return window[k]

            d.update(
                sum=total, mean=total / count,
                p50=pct(50), p90=pct(90), p99=pct(99),
                max=window[-1], min=window[0], unit=self.unit,
            )
        buckets, acc = [], 0
        for i, (ub, c) in enumerate(zip(self.buckets, counts)):
            acc += c
            b = {"le": ub, "count": acc}
            if exemplars[i] is not None:
                b["exemplar"] = exemplars[i]
            buckets.append(b)
        inf_b = {"le": float("inf"), "count": acc + counts[-1]}
        if exemplars[-1] is not None:
            inf_b["exemplar"] = exemplars[-1]
        buckets.append(inf_b)
        d["buckets"] = buckets
        d.setdefault("sum", total)
        if children:
            series = []
            for key, c_count, c_sum, c_counts, c_ex, c_win in sorted(
                children, key=lambda it: it[0]
            ):
                cb, acc2 = [], 0
                for i, (ub, c) in enumerate(zip(self.buckets, c_counts)):
                    acc2 += c
                    b = {"le": ub, "count": acc2}
                    if c_ex[i] is not None:
                        b["exemplar"] = c_ex[i]
                    cb.append(b)
                inf_cb = {"le": float("inf"), "count": acc2 + c_counts[-1]}
                if c_ex[-1] is not None:
                    inf_cb["exemplar"] = c_ex[-1]
                cb.append(inf_cb)
                s = {"labels": dict(key), "count": c_count, "sum": c_sum,
                     "buckets": cb}
                if c_win:
                    def cpct(p):
                        k = max(0, min(len(c_win) - 1,
                                       int(round(p / 100.0
                                                 * (len(c_win) - 1)))))
                        return c_win[k]
                    s.update(p50=cpct(50), p99=cpct(99))
                series.append(s)
            d["series"] = series
        return d


class MetricsRegistry:
    """Name -> instrument map with replace-on-register semantics."""

    def __init__(self):
        self._metrics = {}
        self._lock = threading.RLock()

    def register(self, metric, replace=True):
        name = metric.prom_name
        with self._lock:
            old = self._metrics.get(name)
            if old is not None and not replace and old is not metric:
                raise ValueError(f"metric {name!r} already registered")
            self._metrics[name] = metric
        return metric

    def register_all(self, metrics):
        for m in metrics:
            self.register(m)

    def unregister(self, name):
        with self._lock:
            return self._metrics.pop(name, None)

    def get(self, name):
        with self._lock:
            return self._metrics.get(name)

    def names(self):
        with self._lock:
            return sorted(self._metrics)

    def metrics(self):
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def _get_or_create(self, cls, name, help="", **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls):
                    raise TypeError(
                        f"metric {name!r} is a {m.metric_type}, not a "
                        f"{cls.metric_type}"
                    )
                return m
            m = cls(name, help=help, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name, help="", **kw) -> Counter:
        return self._get_or_create(Counter, name, help=help, **kw)

    def gauge(self, name, help="", **kw) -> Gauge:
        return self._get_or_create(Gauge, name, help=help, **kw)

    def histogram(self, name, help="", **kw) -> Histogram:
        return self._get_or_create(Histogram, name, help=help, **kw)

    def snapshot(self):
        """JSON-able view of every registered instrument."""
        out = {}
        for m in self.metrics():
            try:
                d = m.data()
            except Exception:
                continue
            d["help"] = m.help
            if m.unit:
                d["unit"] = m.unit
            out[m.prom_name] = d
        return {"metrics": out}

    def prometheus_text(self):
        from .exporter import prometheus_text

        return prometheus_text(self)


# The process-wide default registry: serving, analysis, profiler, and
# training telemetry all publish here unless handed another registry.
REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return REGISTRY
