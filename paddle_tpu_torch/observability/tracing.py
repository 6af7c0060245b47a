"""Distributed request tracing — stdlib-only spans stitched across the fleet.

A fleet request crosses three processes (router -> replica engine ->
prefill worker; the serving tier of PRs 10-13) and per-process
aggregate histograms cannot say WHICH hop ate a p99 spike. This module
is the missing substrate: per-request spans with W3C-style
``traceparent`` context propagation over the router->replica HTTP hop
and the KV-transfer frame protocol, collected in bounded per-process
buffers and stitched by ``trace_id`` into one cross-process timeline.

Design points (all stdlib; no OTLP wire format — see the COVERAGE
known-gaps note):

- :class:`Span` — W3C-sized ids (``trace_id`` 16 bytes, ``span_id`` 8
  bytes), a wall-clock ``start`` plus a ``perf_counter`` delta for the
  end so durations stay monotonic-accurate even if the wall clock
  steps, attributes, and a BOUNDED per-span event ring: a 500-step
  decode is ONE span carrying O(ring) step events, never 500 spans.
- :class:`Tracer` — head-based sampling decided ONCE at the trace root
  (``PADDLE_TPU_TRACE_SAMPLE``: ``0`` = tracing off, ``1`` = keep all,
  the default; ``N`` = keep 1-in-N, the bench setting). A sampled-out
  request carries ``None`` context and every downstream
  instrumentation site allocates NOTHING — the decode hot path is
  pinned span-free when sampled out.
- :class:`SpanBuffer` — thread-safe bounded store of FINISHED spans
  grouped by trace (oldest trace evicted whole); the backing store of
  the ``/trace`` endpoints.
- Stitching — each process reports wall-clock spans; :func:`stitch`
  maps a child process onto its parent's clock with the NTP pair
  formula over the HTTP/KV request-response timestamps (client span =
  t0/t3, server span = t1/t2) and records the applied
  ``clock_offset_s`` ON the shifted spans: the estimate is honest,
  never hidden.
- :func:`chrome_trace` — profiler-compatible chrome JSON (``"ph":
  "X"`` complete events, microsecond ts/dur) that
  ``paddle_tpu.profiler.load_profiler_result`` reads back and Perfetto
  renders with router/replica/worker as separate named process rows.

The PyTorch port's line-for-line copy of
``paddle_tpu/observability/tracing.py`` (stdlib only): a port
``traceparent`` parses in JAX and the reverse.
"""
from __future__ import annotations

import collections
import itertools
import json
import os
import re
import threading
import time

TRACEPARENT_HEADER = "traceparent"
SAMPLE_ENV = "PADDLE_TPU_TRACE_SAMPLE"
PROCESS_ENV = "PADDLE_TPU_TRACE_PROCESS"
DEFAULT_EVENT_RING = 256

_TP_RE = re.compile(
    r"^00-(?P<trace_id>[0-9a-f]{32})-(?P<span_id>[0-9a-f]{16})"
    r"-(?P<flags>[0-9a-f]{2})$"
)


def _rand_hex(nbytes):
    return os.urandom(nbytes).hex()


class SpanContext:
    """A parsed ``traceparent``: just enough to parent a remote child."""

    __slots__ = ("trace_id", "span_id", "sampled")

    def __init__(self, trace_id, span_id, sampled=True):
        self.trace_id = str(trace_id)
        self.span_id = str(span_id)
        self.sampled = bool(sampled)

    def traceparent(self):
        return format_traceparent(self)

    def __repr__(self):
        return (f"SpanContext({self.trace_id[:8]}.., {self.span_id}, "
                f"sampled={self.sampled})")


def parse_traceparent(header):
    """Parse a W3C-style ``traceparent``; ``None`` for absent or
    malformed headers (propagation is best-effort — a bad header means
    "start fresh", never an error on the serving path)."""
    if not header or not isinstance(header, str):
        return None
    m = _TP_RE.match(header.strip().lower())
    if m is None:
        return None
    return SpanContext(
        m.group("trace_id"), m.group("span_id"),
        sampled=bool(int(m.group("flags"), 16) & 1),
    )


def format_traceparent(span_or_ctx, sampled=True):
    """``00-<trace_id>-<span_id>-<flags>`` for a Span or SpanContext."""
    flags = "01" if sampled else "00"
    return (f"00-{span_or_ctx.trace_id}-{span_or_ctx.span_id}-{flags}")


class Span:
    """One timed unit of work inside one process.

    ``start``/``end`` are wall-clock seconds (``time.time`` epoch) so
    spans from different processes land on a common axis before any
    offset correction; the END is derived from a ``perf_counter``
    delta, so a span's DURATION is monotonic-accurate even when the
    wall clock steps mid-span. ``events`` is a bounded ring
    (``maxlen=event_ring``) — high-frequency per-step marks coexist
    with the O(1)-spans-per-request discipline."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "process",
                 "start", "end", "attrs", "events", "_mono0", "_tracer")

    def __init__(self, name, trace_id, span_id, parent_id=None,
                 process="", tracer=None, start=None,
                 event_ring=DEFAULT_EVENT_RING):
        self.name = str(name)
        self.trace_id = str(trace_id)
        self.span_id = str(span_id)
        self.parent_id = None if parent_id is None else str(parent_id)
        self.process = str(process)
        now = time.time()
        self.start = now if start is None else float(start)
        # anchored so (perf_now - _mono0) measures from self.start even
        # for retroactive spans whose start predates construction
        self._mono0 = time.perf_counter() - (now - self.start)
        self.end = None
        self.attrs = {}
        self.events = collections.deque(maxlen=int(event_ring))
        self._tracer = tracer

    # ------------------------------------------------------------ content
    def set(self, **attrs):
        self.attrs.update(attrs)
        return self

    def event(self, name, **fields):
        """Append one bounded-ring event (e.g. a decode step mark)."""
        ev = {"name": str(name),
              "t": self.start + (time.perf_counter() - self._mono0)}
        ev.update(fields)
        self.events.append(ev)
        return self

    # ---------------------------------------------------------- lifecycle
    @property
    def finished(self):
        return self.end is not None

    @property
    def duration(self):
        return None if self.end is None else self.end - self.start

    def traceparent(self):
        return format_traceparent(self)

    def finish(self, end=None, **attrs):
        """Idempotent close; pushes the span into its tracer's buffer."""
        if self.end is not None:
            return self
        self.attrs.update(attrs)
        self.end = (self.start + (time.perf_counter() - self._mono0)
                    if end is None else float(end))
        if self._tracer is not None:
            self._tracer._finished(self)
        return self

    # -------------------------------------------------------------- wire
    def to_dict(self):
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "process": self.process,
            "start": self.start,
            "end": self.end,
            "attrs": dict(self.attrs),
            "events": [dict(e) for e in self.events],
        }

    def __repr__(self):
        state = "open" if self.end is None else f"{self.duration:.6f}s"
        return (f"Span({self.name!r}, {self.process}, "
                f"{self.trace_id[:8]}.., {state})")


class SpanBuffer:
    """Thread-safe bounded store of finished spans, grouped by trace.

    Eviction is trace-granular (oldest trace dropped whole — a
    half-evicted trace would stitch into nonsense), bounded both by
    trace count and total span count. Stores plain dicts so spans
    shipped from another process (the KV-frame return path) ingest
    through the same :meth:`add`."""

    def __init__(self, max_spans=4096, max_traces=256):
        self.max_spans = int(max_spans)
        self.max_traces = int(max_traces)
        self._traces = collections.OrderedDict()  # trace_id -> [dict]
        self._count = 0
        self._lock = threading.Lock()

    def add(self, span_dict):
        tid = str(span_dict.get("trace_id"))
        with self._lock:
            lst = self._traces.get(tid)
            if lst is None:
                self._traces[tid] = lst = []
            else:
                self._traces.move_to_end(tid)
            lst.append(dict(span_dict))
            self._count += 1
            while (len(self._traces) > self.max_traces
                   or self._count > self.max_spans):
                if len(self._traces) == 1:
                    # single oversized trace: trim its oldest spans
                    drop = self._count - self.max_spans
                    if drop <= 0:
                        break
                    del lst[:drop]
                    self._count -= drop
                    break
                _, dropped = self._traces.popitem(last=False)
                self._count -= len(dropped)

    def __len__(self):
        with self._lock:
            return self._count

    def trace_ids(self):
        with self._lock:
            return list(self._traces)

    def get(self, trace_id):
        with self._lock:
            return [dict(s) for s in self._traces.get(str(trace_id), ())]

    def traces(self, limit=None):
        """Recent traces, most recently touched FIRST."""
        with self._lock:
            items = [(t, [dict(s) for s in sp])
                     for t, sp in self._traces.items()]
        items.reverse()
        if limit is not None:
            items = items[: int(limit)]
        return [{"trace_id": t, "spans": sp} for t, sp in items]

    def spans(self):
        with self._lock:
            return [dict(s) for sp in self._traces.values() for s in sp]

    def clear(self):
        with self._lock:
            self._traces.clear()
            self._count = 0


class Tracer:
    """Span factory with head-based sampling + in-flight registry.

    The sampling decision happens exactly once per trace, at
    :meth:`start_trace` — everything downstream keys off whether it
    holds a parent span (``None`` = sampled out = allocate nothing).
    ``sample`` resolves from ``PADDLE_TPU_TRACE_SAMPLE`` at each root
    (0 = off, 1 = keep all, N = 1-in-N) unless pinned by the
    constructor. Unfinished spans are tracked (bounded) so a
    flight-recorder bundle can name the requests in flight."""

    def __init__(self, process=None, buffer=None, sample=None,
                 event_ring=DEFAULT_EVENT_RING, max_active=4096):
        self.process = (process or os.environ.get(PROCESS_ENV)
                        or f"pid{os.getpid()}")
        self.buffer = buffer if buffer is not None else SpanBuffer()
        self._sample = sample
        self._heads = itertools.count()
        self.event_ring = int(event_ring)
        self.spans_started = 0
        self._active = collections.OrderedDict()
        self._max_active = int(max_active)
        self._lock = threading.Lock()

    # ----------------------------------------------------------- sampling
    @property
    def sample(self):
        if self._sample is not None:
            return int(self._sample)
        try:
            return int(os.environ.get(SAMPLE_ENV, "1"))
        except ValueError:
            return 1

    def _head_sampled(self):
        n = self.sample
        if n <= 0:
            return False
        if n == 1:
            return True
        return next(self._heads) % n == 0

    # ----------------------------------------------------------- creation
    def _make(self, name, trace_id, parent_id, attrs, start=None,
              process=None):
        sp = Span(name, trace_id, _rand_hex(8), parent_id=parent_id,
                  process=self.process if process is None else process,
                  tracer=self, start=start, event_ring=self.event_ring)
        if attrs:
            sp.attrs.update(attrs)
        with self._lock:
            self.spans_started += 1
            self._active[sp.span_id] = sp
            while len(self._active) > self._max_active:
                self._active.popitem(last=False)
        return sp

    def start_trace(self, name, process=None, **attrs):
        """New root span — THE head-sampling point. ``None`` when this
        trace is sampled out; callers propagate that ``None`` and no
        further tracing work happens for the request."""
        if not self._head_sampled():
            return None
        return self._make(name, _rand_hex(16), None, attrs,
                          process=process)

    def start_span(self, name, parent, process=None, **attrs):
        """Child span under ``parent`` (a Span, SpanContext, or raw
        traceparent string). ``None`` parent — or an unsampled /
        malformed remote context — yields ``None``: sampled-out stays
        allocation-free all the way down."""
        if parent is None:
            return None
        if isinstance(parent, str):
            parent = parse_traceparent(parent)
            if parent is None:
                return None
        if isinstance(parent, SpanContext) and not parent.sampled:
            return None
        return self._make(name, parent.trace_id, parent.span_id, attrs,
                          process=process)

    def record_span(self, name, parent, duration, end=None, **attrs):
        """Already-finished retroactive span: ends now (or at ``end``),
        started ``duration`` earlier — how the engine renders a
        scheduler-measured queue wait as a span without having traced
        through the queue. ``None`` parent => ``None``."""
        if parent is None:
            return None
        t1 = time.time() if end is None else float(end)
        sp = self.start_span(name, parent, **attrs)
        if sp is None:
            return None
        sp.start = t1 - float(duration)
        sp._mono0 = time.perf_counter() - (time.time() - sp.start)
        return sp.finish(end=t1)

    def record_trace(self, name, duration, end=None, **attrs):
        """Retroactive ROOT span (head-sampled): e.g. the engine's
        reload admission-pause, which is request-independent."""
        if not self._head_sampled():
            return None
        t1 = time.time() if end is None else float(end)
        sp = self._make(name, _rand_hex(16), None, attrs)
        sp.start = t1 - float(duration)
        sp._mono0 = time.perf_counter() - (time.time() - sp.start)
        return sp.finish(end=t1)

    # ------------------------------------------------------------ plumbing
    def _finished(self, span):
        with self._lock:
            self._active.pop(span.span_id, None)
        self.buffer.add(span.to_dict())

    def active_spans(self):
        with self._lock:
            act = list(self._active.values())
        return [s.to_dict() for s in act]

    def active_trace_ids(self):
        with self._lock:
            return sorted({s.trace_id for s in self._active.values()})


def remote_child_span(name, ctx, process, event_ring=DEFAULT_EVENT_RING):
    """A span for remote-parented work whose record travels back to the
    caller IN the response (the KV-frame pattern: the prefill worker
    ships its span dict in the ``prefilled`` header and the CLIENT's
    buffer records it) — deliberately tracer-less so an in-process
    worker doesn't double-record into the shared buffer."""
    if isinstance(ctx, str):
        ctx = parse_traceparent(ctx)
    if ctx is None or not getattr(ctx, "sampled", True):
        return None
    return Span(name, ctx.trace_id, _rand_hex(8),
                parent_id=ctx.span_id, process=process,
                event_ring=event_ring)


# ------------------------------------------------------- process default
_DEFAULT = [None]
_DEFAULT_LOCK = threading.Lock()


def get_tracer() -> Tracer:
    with _DEFAULT_LOCK:
        if _DEFAULT[0] is None:
            _DEFAULT[0] = Tracer()
        return _DEFAULT[0]


def set_tracer(tracer):
    with _DEFAULT_LOCK:
        prev, _DEFAULT[0] = _DEFAULT[0], tracer
    return prev


def set_process_name(name):
    """Tag this process's spans (launch.py sets the fleet role)."""
    get_tracer().process = str(name)


# ------------------------------------------------------------- stitching
def estimate_offset(client_span, server_span):
    """NTP pair estimate of (server clock - client clock): with the
    client span bracketing the request (t0=start, t3=end) and the
    server span the handling (t1=start, t2=end),
    ``((t1-t0)+(t2-t3))/2`` is the classic symmetric-delay offset.
    Subtract it from server times to land on the client's clock."""
    t0, t3 = float(client_span["start"]), float(client_span["end"])
    t1 = float(server_span["start"])
    t2 = (float(server_span["end"])
          if server_span.get("end") is not None else t1)
    return ((t1 - t0) + (t2 - t3)) / 2.0


def stitch(spans):
    """Cross-process alignment: group span dicts by trace, pick the
    root process (the one holding the parentless span), and chain NTP
    offsets along cross-process parent->child edges (router->replica
    HTTP hop, replica->worker KV hop). Shifted spans carry the applied
    ``clock_offset_s`` attribute — the estimate is explicit, not
    hidden. Returns adjusted COPIES; input is untouched."""
    flat = []
    for s in spans:
        if "spans" in s and "trace_id" in s and "span_id" not in s:
            flat.extend(s["spans"])  # accept /trace-style groups too
        else:
            flat.append(s)
    by_trace = collections.OrderedDict()
    for s in flat:
        by_trace.setdefault(str(s.get("trace_id")), []).append(s)
    out = []
    for group in by_trace.values():
        out.extend(_stitch_one(group))
    return out


def _stitch_one(group):
    by_id = {s["span_id"]: s for s in group}
    edges = {}  # (client_proc, server_proc) -> (client, server)
    for s in group:
        p = by_id.get(s.get("parent_id") or "")
        if (p is not None and p.get("process") != s.get("process")
                and p.get("end") is not None):
            edges.setdefault(
                (p["process"], s["process"]), (p, s)
            )
    root = next(
        (s["process"] for s in group if not s.get("parent_id")),
        group[0]["process"],
    )
    offset = {root: 0.0}
    changed = True
    while changed:
        changed = False
        for (cp, sp), (c, s) in edges.items():
            if cp in offset and sp not in offset:
                offset[sp] = offset[cp] + estimate_offset(c, s)
                changed = True
    out = []
    for s in group:
        d = dict(s)
        d["attrs"] = dict(s.get("attrs") or {})
        off = offset.get(s.get("process"), 0.0)
        if off:
            d["start"] = float(d["start"]) - off
            if d.get("end") is not None:
                d["end"] = float(d["end"]) - off
            d["events"] = [
                dict(e, t=float(e.get("t", 0.0)) - off)
                for e in (s.get("events") or ())
            ]
            d["attrs"]["clock_offset_s"] = off
        out.append(d)
    return out


# ---------------------------------------------------------- chrome export
def chrome_trace(spans, normalize=True):
    """Span dicts -> chrome://tracing JSON dict. Complete events use
    ``"ph": "X"`` with microsecond ``ts``/``dur`` — byte-compatible
    with what ``profiler.export_chrome_tracing`` writes, so
    ``profiler.load_profiler_result`` reads the file back and Perfetto
    opens it directly. Each fleet process gets its own ``pid`` row
    (named via ``process_name`` metadata); traces stack as one ``tid``
    lane per (process, trace). Span events become instant (``"i"``)
    marks — skipped by the loader, visible in Perfetto."""
    flat = stitch(spans) if spans else []
    flat = [s for s in flat if s.get("end") is not None]
    pids, lanes = {}, {}
    for s in flat:
        pids.setdefault(s.get("process") or "?", len(pids) + 1)
        key = (s.get("process") or "?", s.get("trace_id"))
        lanes.setdefault(key, len([
            1 for k in lanes if k[0] == (s.get("process") or "?")
        ]))
    t0 = min((float(s["start"]) for s in flat), default=0.0) \
        if normalize else 0.0
    events = []
    for proc, pid in pids.items():
        events.append({
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": proc},
        })
    for s in flat:
        proc = s.get("process") or "?"
        pid = pids[proc]
        tid = lanes[(proc, s.get("trace_id"))]
        args = dict(s.get("attrs") or {})
        args["trace_id"] = s.get("trace_id")
        args["span_id"] = s.get("span_id")
        if s.get("parent_id"):
            args["parent_id"] = s["parent_id"]
        events.append({
            "name": s.get("name", ""), "cat": "span", "ph": "X",
            "ts": (float(s["start"]) - t0) * 1e6,
            "dur": (float(s["end"]) - float(s["start"])) * 1e6,
            "pid": pid, "tid": tid, "args": args,
        })
        for e in s.get("events") or ():
            ea = {k: v for k, v in e.items() if k not in ("name", "t")}
            ea["trace_id"] = s.get("trace_id")
            events.append({
                "name": e.get("name", "event"), "cat": "span_event",
                "ph": "i", "s": "t",
                "ts": (float(e.get("t", s["start"])) - t0) * 1e6,
                "pid": pid, "tid": tid, "args": ea,
            })
    return {"traceEvents": events}


def export_chrome(path, spans, normalize=True):
    """Write :func:`chrome_trace` JSON to ``path``; returns the path."""
    doc = chrome_trace(spans, normalize=normalize)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def trace_payload(tracer=None, limit=64):
    """The ``/trace`` endpoint body: this process's recent finished
    traces (front-ends serve it via ``httpd.send_json``)."""
    tr = tracer or get_tracer()
    return {
        "process": tr.process,
        "sample": tr.sample,
        "traces": tr.buffer.traces(limit=limit),
    }
