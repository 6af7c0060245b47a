"""Prometheus text exposition + stdlib-only /metrics HTTP endpoint.

The registry's wire formats:

- :func:`prometheus_text` renders a :class:`~.registry.MetricsRegistry`
  in Prometheus text format 0.0.4 (``# HELP``/``# TYPE`` headers,
  ``_total`` counters, cumulative ``_bucket{le=...}`` histograms).
- :func:`parse_prometheus_text` reads that format back into
  ``{series_name: [(labels, value), ...]}`` — used by the smoke gate to
  assert the exposition is well-formed without a prometheus dependency.
- :class:`MetricsServer` serves ``/metrics`` (text), ``/metrics.json``
  (registry snapshot), ``/flight`` (the flight recorder's current
  bundle), and ``/trace`` (recent finished spans from the process
  tracer) from a daemon thread over ``http.server`` — no third-party
  server; scraping a training job is one stdlib import away.
"""
from __future__ import annotations

import json
import math
import os
import re
import threading

from .registry import get_registry

# OpenMetrics-style exemplars in the text exposition are behind a flag:
# classic Prometheus text-format scrapers reject the suffix, so emitting
# it must be an explicit choice (env or prometheus_text(exemplars=True))
EXEMPLARS_ENV = "PADDLE_TPU_METRICS_EXEMPLARS"


def _exemplars_enabled(flag):
    if flag is not None:
        return bool(flag)
    return os.environ.get(EXEMPLARS_ENV, "").lower() in (
        "1", "true", "yes", "on"
    )


def _fmt_exemplar(ex):
    """OpenMetrics exemplar suffix: `` # {trace_id="..."} <value>``."""
    if not ex:
        return ""
    labels = {
        k: v for k, v in ex.items() if k not in ("value",)
    }
    return (f" # {_fmt_labels(labels) or '{}'}"
            f" {_fmt_value(float(ex.get('value', 0.0)))}")

_NAME_OK = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")
_NAME_FIX = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_FIX = re.compile(r"[^a-zA-Z0-9_]")


def _sanitize_name(name):
    if _NAME_OK.match(name):
        return name
    name = _NAME_FIX.sub("_", name)
    if not name or not _NAME_OK.match(name):
        name = "_" + name
    return name


def _escape_label(v):
    # \r must be escaped too: splitlines() (ours and Prometheus's line
    # scanner) would split a label value mid-line otherwise
    return (
        str(v).replace("\\", "\\\\").replace('"', '\\"')
        .replace("\n", "\\n").replace("\r", "\\r")
    )


def _fmt_labels(labels):
    if not labels:
        return ""
    inner = ",".join(
        f'{_LABEL_FIX.sub("_", str(k))}="{_escape_label(v)}"'
        for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def _fmt_value(v):
    if isinstance(v, float) and math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if isinstance(v, float) and math.isnan(v):
        return "NaN"
    return repr(float(v)) if isinstance(v, float) else str(v)


def prometheus_text(registry=None, exemplars=None):
    """Render ``registry`` (default: the process registry) in Prometheus
    text exposition format 0.0.4.

    ``exemplars=True`` (or ``PADDLE_TPU_METRICS_EXEMPLARS=1`` when the
    argument is left ``None``) appends OpenMetrics-style
    `` # {trace_id="..."} <value>`` exemplar suffixes to counter and
    histogram-bucket samples that have one recorded — the hook from a
    latency bucket straight to a distributed trace. Off by default:
    classic text-format scrapers reject the suffix."""
    registry = registry or get_registry()
    ex_on = _exemplars_enabled(exemplars)

    def ex_suffix(ex):
        return _fmt_exemplar(ex) if ex_on and ex else ""

    lines = []
    for m in registry.metrics():
        name = _sanitize_name(m.prom_name)
        try:
            d = m.data()
        except Exception:
            continue
        kind = d.get("type", "untyped")
        if m.help:
            lines.append(f"# HELP {name} {m.help}")
        lines.append(f"# TYPE {name} {kind}")
        if kind == "counter":
            total = name if name.endswith("_total") else name + "_total"
            series = d.get("series", [])
            if not series:
                lines.append(
                    f"{total} {_fmt_value(d['value'])}"
                    f"{ex_suffix(d.get('exemplar'))}"
                )
            else:
                # one family must not mix a bare aggregate with labeled
                # children — sum(rate(...)) would double-count. Emit the
                # children; any unlabeled increments (mixed usage) go
                # out as a remainder sample with empty label values.
                for s in series:
                    lines.append(
                        f"{total}{_fmt_labels(s['labels'])} "
                        f"{_fmt_value(s['value'])}"
                        f"{ex_suffix(s.get('exemplar'))}"
                    )
                rest = d["value"] - sum(s["value"] for s in series)
                if rest:
                    # union of every child's label keys: a remainder
                    # labeled with only one child's keys would vanish
                    # from sum by(<other_key>) queries
                    blank = {
                        k: "" for s in series for k in s["labels"]
                    }
                    lines.append(
                        f"{total}{_fmt_labels(blank)} {_fmt_value(rest)}"
                    )
        elif kind == "gauge":
            for s in d.get("series", []):
                lines.append(
                    f"{name}{_fmt_labels(s['labels'])} "
                    f"{_fmt_value(s['value'])}"
                )
        elif kind == "histogram":
            series = d.get("series", [])
            if not series:
                for b in d.get("buckets", []):
                    le = b["le"]
                    le_s = ("+Inf" if math.isinf(le)
                            else _fmt_value(float(le)))
                    lines.append(
                        f'{name}_bucket{{le="{le_s}"}} {b["count"]}'
                        f"{ex_suffix(b.get('exemplar'))}"
                    )
                lines.append(f"{name}_sum {_fmt_value(d.get('sum', 0.0))}")
                lines.append(f"{name}_count {d.get('count', 0)}")
            else:
                # same no-mixing discipline as counters: a labeled
                # histogram family emits per-child buckets/_sum/_count
                # plus a blank-labeled remainder for any unlabeled
                # observes — never a bare aggregate alongside children
                # (sum(rate(..._bucket[5m])) would double-count).
                blank = {k: "" for s in series for k in s["labels"]}

                def emit_child(labels, buckets, csum, ccount, ex_ok=True):
                    for b in buckets:
                        le = b["le"]
                        le_s = ("+Inf" if math.isinf(le)
                                else _fmt_value(float(le)))
                        lb = dict(labels)
                        lb["le"] = le_s
                        ex = ex_suffix(b.get("exemplar")) if ex_ok else ""
                        lines.append(
                            f'{name}_bucket{_fmt_labels(lb)} '
                            f'{b["count"]}{ex}'
                        )
                    lines.append(
                        f"{name}_sum{_fmt_labels(labels)} "
                        f"{_fmt_value(csum)}"
                    )
                    lines.append(
                        f"{name}_count{_fmt_labels(labels)} {ccount}"
                    )

                for s in series:
                    emit_child(s["labels"], s["buckets"], s.get("sum", 0.0),
                               s.get("count", 0))
                rest_count = d.get("count", 0) - sum(
                    s.get("count", 0) for s in series
                )
                if rest_count:
                    rest_sum = d.get("sum", 0.0) - sum(
                        s.get("sum", 0.0) for s in series
                    )
                    rest_buckets = []
                    for i, b in enumerate(d.get("buckets", [])):
                        child_c = sum(
                            s["buckets"][i]["count"] for s in series
                        )
                        # remainder carries no exemplar: the parent's
                        # slot exemplar may belong to a labeled observe
                        rest_buckets.append(
                            {"le": b["le"], "count": b["count"] - child_c}
                        )
                    emit_child(blank, rest_buckets, rest_sum, rest_count,
                               ex_ok=False)
        else:
            for s in d.get("series", []):
                lines.append(
                    f"{name}{_fmt_labels(s['labels'])} "
                    f"{_fmt_value(s['value'])}"
                )
    return "\n".join(lines) + "\n"


# the labels block must be matched as a sequence of quoted pairs, NOT
# [^}]* — a '}' inside a quoted label value (repr'd dict/shape keys from
# trace-guard graphs) is legal exposition
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
_LABELS_BLOCK = (
    r'(?:[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*"\s*,?\s*)*'
)
# OpenMetrics exemplar suffix: `` # {labels} value [timestamp]`` — the
# same quoted-pair labels grammar as the sample's own block (an
# exemplar trace_id may hold escaped chars too), value/timestamp as
# bare tokens validated numerically after the match
_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>" + _LABELS_BLOCK + r")\})?\s+(?P<value>[^\s#]+)"
    r"(?:\s+#\s*\{(?P<ex_labels>" + _LABELS_BLOCK + r")\}"
    r"\s+(?P<ex_value>[^\s#]+)(?:\s+(?P<ex_ts>[^\s#]+))?)?\s*$"
)
_UNESCAPE_RE = re.compile(r"\\(.)")


def _unescape_label(v):
    # single pass, so an escaped backslash can never re-combine with the
    # following char into a bogus escape (\\n must stay backslash+n)
    return _UNESCAPE_RE.sub(
        lambda m: {"n": "\n", "r": "\r"}.get(m.group(1), m.group(1)), v
    )


def _parse_value(v, line):
    value = {"+Inf": math.inf, "-Inf": -math.inf, "NaN": math.nan}.get(v)
    if value is None:
        try:
            value = float(v)
        except ValueError:
            raise ValueError(
                f"malformed sample value {v!r} on line: {line!r}"
            ) from None
    return value


def parse_prometheus_text(text, exemplars=False):
    """Parse exposition text into ``{series_name: [(labels, value)]}``.

    Strict about sample-line shape (a malformed line raises ValueError,
    which is exactly what the smoke gate wants to catch); comment and
    blank lines are skipped. Exemplar suffixes (`` # {...} value``) are
    validated on EVERY line — a malformed exemplar is a clear,
    dedicated ValueError, never silently dropped; with
    ``exemplars=True`` the return is ``(series, exemplar_list)`` where
    each exemplar entry is ``{"series", "labels", "exemplar_labels",
    "value"}``."""
    out = {}
    found = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            if "#" in line:
                raise ValueError(
                    "malformed exemplar (expected "
                    "'# {label=\"v\",...} value [timestamp]') on "
                    f"line: {line!r}"
                )
            raise ValueError(f"malformed exposition line: {line!r}")
        labels = {}
        if m.group("labels"):
            for lm in _LABEL_RE.finditer(m.group("labels")):
                labels[lm.group(1)] = _unescape_label(lm.group(2))
        value = _parse_value(m.group("value"), line)
        name = m.group("name")
        out.setdefault(name, []).append((labels, value))
        if m.group("ex_value") is not None:
            ex_labels = {}
            for lm in _LABEL_RE.finditer(m.group("ex_labels") or ""):
                ex_labels[lm.group(1)] = _unescape_label(lm.group(2))
            ex_value = _parse_value(m.group("ex_value"), line)
            if m.group("ex_ts") is not None:
                _parse_value(m.group("ex_ts"), line)  # validate only
            found.append({
                "series": name,
                "labels": labels,
                "exemplar_labels": ex_labels,
                "value": ex_value,
            })
    return (out, found) if exemplars else out


class MetricsServer:
    """Optional ``/metrics`` endpoint over ``http.server`` (stdlib only).

    ``port=0`` binds an ephemeral port (read it back from ``.port``).
    The serving thread is a daemon: it never blocks process exit."""

    def __init__(self, port=0, host="127.0.0.1", registry=None):
        self.host = host
        self.port = int(port)
        self.registry = registry or get_registry()
        self._httpd = None
        self._thread = None

    def start(self):
        import http.server

        registry = self.registry

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet: no per-scrape stderr
                pass

            def _send(self, body, ctype):
                data = body.encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                try:
                    if path in ("/metrics", "/"):
                        self._send(
                            prometheus_text(registry),
                            "text/plain; version=0.0.4; charset=utf-8",
                        )
                    elif path == "/metrics.json":
                        self._send(
                            json.dumps(registry.snapshot(), default=str),
                            "application/json",
                        )
                    elif path == "/flight":
                        from .flight_recorder import get_flight_recorder

                        self._send(
                            json.dumps(
                                get_flight_recorder().bundle(
                                    reason="http:/flight"
                                ),
                                default=str,
                            ),
                            "application/json",
                        )
                    elif path == "/trace":
                        from .tracing import trace_payload

                        self._send(
                            json.dumps(trace_payload(), default=str),
                            "application/json",
                        )
                    else:
                        self.send_error(404)
                except Exception as e:  # a broken scrape must not kill
                    try:                # the serving thread
                        self.send_error(500, str(e))
                    except Exception:
                        pass

        self._httpd = http.server.ThreadingHTTPServer(
            (self.host, self.port), Handler
        )
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="paddle-metrics-http",
            daemon=True,
        )
        self._thread.start()
        return self

    @property
    def url(self):
        return f"http://{self.host}:{self.port}/metrics"

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False


def start_metrics_server(port=0, host="127.0.0.1", registry=None):
    """Start a daemon-thread /metrics endpoint; returns the server
    (``server.port`` holds the bound port, ``server.stop()`` ends it)."""
    return MetricsServer(port=port, host=host, registry=registry).start()
