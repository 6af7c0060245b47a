"""Streaming HTTP/SSE front-end over a serving engine — stdlib only.

The network surface the serving stack was missing: POST a request, get
the tokens back as a Server-Sent-Events stream while the engine
decodes. Built on the same ``http.server`` seam as
``observability.exporter.MetricsServer`` — no third-party server, one
import to put a model on a port.

Endpoints:

- ``POST /v1/generate`` — body ``{"input_ids": [...],
  "max_new_tokens": N, "eos_token_id"?, "priority"?, "deadline_s"?,
  "stream"? (default true)}``. Streaming responses are
  ``text/event-stream``::

      event: token
      data: {"index": 0, "token": 17}

      event: done
      data: {"status": "DONE", "tokens": [...], ...}

  A request that ends any other way — queue-bound deadline, engine
  close, slow consumer — ends the stream with a TERMINAL ``event:
  error`` carrying the machine-readable reason (never a silent hang;
  ``paddle_serving_stream_aborts_total{reason}`` counts each).
  Backpressure surfaces as HTTP status BEFORE the stream opens:
  429 queue_full, 413 too_long, 400 malformed/shape_mismatch,
  503 engine_closed. ``"stream": false`` blocks and returns one JSON
  body instead.
- ``GET /metrics`` — the process Prometheus exposition (wire-level
  TTFT/ITL land here as ``paddle_serving_wire_{ttft,itl}_seconds``,
  measured at write() time — queueing, serialization and socket
  included, the latency a user actually sees).
- ``GET /healthz`` — engine/pool/queue stats as JSON.

Threading model: the engine is NOT thread-safe, so exactly one driver
thread steps it; HTTP handler threads only (a) submit under the
frontend lock and (b) consume their request's event queue, which the
engine's per-token callbacks feed from the driver thread. A slow or
disconnected client therefore can never stall the decode loop — its
stream is aborted and counted instead.

The PyTorch port's copy of ``paddle_tpu/serving/http_frontend.py``: the
same endpoints, status codes, SSE events, terminal reasons and
``/healthz`` keys. What differs:

- CUDA graphs and threads. The driver thread replays the programs the
  engine captured, on the CUDA stream that was current on the thread
  that called :meth:`ServingFrontend.start` (PyTorch's current stream
  is per thread). A capture must not run beside another thread's CUDA
  work, and a program not captured yet would be captured at its first
  use, on the driver thread, while handler threads run. So ``start()``
  first warms the engine (``engine.warmup()``: every program not
  captured yet) before it opens the port, and ``/healthz`` reads only
  host-side numbers the engine already holds;
- ``POST /reload`` prepares on the handler thread (``prepare_reload``
  loads onto the card there, beside the driver's replays) and commits
  under the lock, as in JAX;
- JAX's ``StaticBatchEngine`` has no port counterpart yet, so the driver
  only ``step()``s; the lock sentinel (``maybe_instrument``) waits with
  ``ROADMAP.md`` queue A item 7.
"""
from __future__ import annotations

import collections
import json
import math
import os
import queue
import threading
import time

from ..observability import get_registry
from ..observability.exporter import prometheus_text
from ..observability.tracing import (
    TRACEPARENT_HEADER,
    get_tracer,
    parse_traceparent,
    trace_payload,
)
from .metrics import Counter, Histogram

# terminal abort reasons surfaced on streams (engine REASON_* strings
# pass through verbatim; these are the frontend-originated ones)
ABORT_CLIENT_DISCONNECT = "client_disconnect"
ABORT_STREAM_STALL = "stream_stall"
ABORT_FRONTEND_STOPPED = "frontend_stopped"

_STATUS_FOR_REASON = {
    "queue_full": 429,
    "too_long": 413,
    "shape_mismatch": 400,
    "engine_closed": 503,
    "draining": 503,
}


class FrontendMetrics:
    """Wire-level series, one instance per frontend (replace-on-register
    in the process registry, like ServingMetrics)."""

    def __init__(self, registry=None, namespace="paddle_serving"):
        ns = namespace
        self.wire_ttft = Histogram(
            "wire_ttft", prom_name=f"{ns}_wire_ttft_seconds",
            help="request-received to first token byte written")
        self.wire_itl = Histogram(
            "wire_itl", prom_name=f"{ns}_wire_itl_seconds",
            help="gap between consecutive token writes on one stream")
        self.stream_aborts = Counter(
            "stream_aborts", labelname="reason",
            prom_name=f"{ns}_stream_aborts_total",
            help="streams ended by a terminal error event, by reason")
        self.http_requests = Counter(
            "http_requests", labelname="code",
            prom_name=f"{ns}_http_requests_total",
            help="front-end HTTP responses, by status code")
        reg = registry or get_registry()
        reg.register_all([
            self.wire_ttft, self.wire_itl, self.stream_aborts,
            self.http_requests,
        ])


class ServingFrontend:
    """HTTP/SSE front-end driving one engine on a background thread.

    ``port=0`` binds an ephemeral port (read ``.port`` back). Works with
    :class:`~.engine.ServingEngine` and :class:`~.paged_engine.
    PagedServingEngine` — any engine with the submit/streaming-callback
    surface and a ``step()``.
    """

    def __init__(self, engine, host="127.0.0.1", port=0, registry=None,
                 stream_timeout_s=120.0, slo_monitor=None):
        self.engine = engine
        self.host = host
        self.port = int(port)
        self.metrics = FrontendMetrics(registry=registry)
        self.stream_timeout_s = float(stream_timeout_s)
        # SLO observability plane: the monitor backs /alerts and the
        # healthz alerts block. A caller-provided monitor is used as-is
        # (the caller owns its sampling); otherwise one is created and
        # its background sampler starts with the frontend when
        # PADDLE_TPU_SLO_INTERVAL (seconds) is set.
        if slo_monitor is None:
            from ..observability.slo import SLOMonitor

            iv = os.environ.get("PADDLE_TPU_SLO_INTERVAL")
            slo_monitor = SLOMonitor(
                registry=registry,
                interval_s=float(iv) if iv else 5.0,
            )
            self._own_slo_monitor = bool(iv)
        else:
            self._own_slo_monitor = False
        self.slo_monitor = slo_monitor
        # graceful drain: a draining frontend stops ADMITTING (new
        # generate requests get 503 {"reason": "draining"}) but keeps
        # the driver stepping, so every in-flight stream finishes —
        # the router rotates a replica out with zero dropped requests
        self.draining = False
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._httpd = None
        self._http_thread = None
        self._driver_thread = None
        # (time, repr) of swallowed step errors — bounded so a
        # persistently failing step cannot grow memory without limit.
        self.driver_errors = collections.deque(maxlen=256)
        self._stream = None  # the CUDA stream the driver replays on

    # ---------------------------------------------------------- lifecycle
    def start(self):
        """Warm the engine (capture every program not captured yet, on
        this thread, while nothing else runs), then open the port and
        start the driver thread."""
        from .httpd import start_http_server

        self._warm_engine()
        self._httpd, self._http_thread = start_http_server(
            self.host, self.port, self._handle_get, self._handle_post,
            name="paddle-serve-http",
        )
        self.port = self._httpd.server_address[1]
        self._driver_thread = threading.Thread(
            target=self._drive, name="paddle-serve-driver", daemon=True,
        )
        self._driver_thread.start()
        if self._own_slo_monitor:
            self.slo_monitor.start()
        return self

    def stop(self, close_engine=False):
        """Stop serving. Open streams get a terminal
        ``frontend_stopped``/engine-close error event rather than a
        hang (``close_engine=True`` cancels in-flight requests, which
        fires their terminal callbacks)."""
        self._stop.set()
        if self._own_slo_monitor:
            self.slo_monitor.stop()
        if close_engine:
            with self._lock:
                try:
                    self.engine.close()
                except Exception:
                    pass
        if self._driver_thread is not None:
            self._driver_thread.join(timeout=10)
            self._driver_thread = None
        from .httpd import stop_http_server

        stop_http_server(self._httpd, self._http_thread)
        self._httpd = None
        self._http_thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    @property
    def url(self):
        return f"http://{self.host}:{self.port}"

    # ------------------------------------------------------------- driver
    def _engine_busy(self):
        depth = getattr(self.engine.scheduler, "depth", 0)
        active = getattr(self.engine, "active_slots", 0)
        return bool(depth or active)

    def _warm_engine(self):
        eng = self.engine
        if getattr(eng, "graphs", False) and not getattr(eng, "_closed",
                                                         False) \
                and not self._engine_busy():
            eng.warmup()
        device = getattr(eng, "device", None)
        if getattr(device, "type", None) == "cuda":
            import torch

            self._stream = torch.cuda.current_stream(device)

    def _drive(self):
        if self._stream is not None:
            import torch

            with torch.cuda.stream(self._stream):
                self._drive_loop()
        else:
            self._drive_loop()

    def _drive_loop(self):
        stepper = self.engine.step
        while not self._stop.is_set():
            busy = False
            errored = False
            with self._lock:
                if self._engine_busy() and not getattr(
                    self.engine, "_closed", False
                ):
                    busy = True
                    try:
                        stepper()
                    except Exception as e:  # a failed admission already
                        # resolved its handle; the loop must survive
                        errored = True
                        self.driver_errors.append(
                            (time.monotonic(), repr(e))
                        )
            if errored:
                # Back off: a persistently failing step() must not spin
                # a core at full speed while it keeps failing.
                time.sleep(0.005)
            elif not busy:
                time.sleep(0.001)

    # ----------------------------------------------------------- handlers
    def _send_json(self, h, code, obj):
        from .httpd import send_json

        send_json(h, code, obj)
        self.metrics.http_requests.inc(label=str(code))

    def _handle_get(self, h):
        from .httpd import send_text

        path = h.path.split("?", 1)[0]
        try:
            if path == "/metrics":
                send_text(
                    h, 200, prometheus_text().encode("utf-8"),
                    "text/plain; version=0.0.4; charset=utf-8",
                )
                self.metrics.http_requests.inc(label="200")
            elif path == "/trace":
                self._send_json(h, 200, trace_payload())
            elif path == "/alerts":
                self._send_json(h, 200, self.slo_monitor.status())
            elif path == "/healthz":
                self._send_json(h, 200, self.health())
            else:
                self._send_json(h, 404, {"error": "not found"})
        except Exception as e:
            try:
                self._send_json(h, 500, {"error": repr(e)})
            except Exception:
                pass

    def health(self):
        """Machine-readable replica status — the routing-admission
        signal a fleet router scrapes, not just a liveness bit: free
        pages (capacity), queue depth + in-flight (pressure), engine
        generation/weights version (routing can pin a version during a
        rollout), and the draining/accepting flags.

        Deliberately lock-free (taking the driver lock would queue
        scrapes behind whole engine steps and age healthy replicas out
        of the router's rotation under load), so the pool/prefix-cache
        stats may race a driver-thread mutation mid-iteration — a
        transient "dict changed size"/KeyError is retried rather than
        500ing a healthy replica."""
        for _ in range(5):
            try:
                return self._health_snapshot()
            except (RuntimeError, KeyError):
                continue
        return self._health_snapshot()

    def _health_snapshot(self):
        eng = self.engine
        queue_depth = getattr(eng.scheduler, "depth", 0)
        active = getattr(eng, "active_slots", 0)
        closed = bool(getattr(eng, "_closed", False))
        out = {
            "queue_depth": queue_depth,
            "active": active,
            "in_flight": queue_depth + active,
            "closed": closed,
            "draining": bool(self.draining),
            "accepting": not closed and not self.draining,
            "engine": type(eng).__name__,
            "generation": getattr(eng, "generation", 0),
            "weights_version": getattr(eng, "weights_version", None),
            "last_reload_step": getattr(eng, "last_reload_step", None),
            "reload_in_progress": bool(
                getattr(eng, "reload_in_progress", False)
            ),
            "compile_cache_hits": getattr(eng, "compile_cache_hits", 0),
            "max_queue_size": getattr(eng.scheduler, "max_queue_size",
                                      None),
            # burn-rate alert block: what the fleet router aggregates —
            # a fleet-wide SLO breach is one /healthz scrape away
            "alerts": self.slo_monitor.alerts_block(),
        }
        guard = getattr(eng, "trace_guard", None)
        if guard is not None:
            # total compiled-program inventory: a warm-started replica
            # must show this number UNCHANGED across first traffic
            out["compile_entries"] = int(
                sum(guard.compile_counts().values())
            )
        pool = getattr(eng, "pool", None)
        if pool is not None:
            out["pool"] = pool.stats()
        page_pool = getattr(eng, "page_pool", None)
        if page_pool is not None:
            out["page_pool"] = page_pool.stats()
            out["free_pages"] = page_pool.free_pages
            prefix = getattr(eng, "prefix_cache", None)
            if prefix is not None:
                # warm-capacity signal for the fleet router: hit stats
                # drive the cache-affinity bonus in its load score
                out["prefix_cache"] = prefix.stats()
            tier = getattr(eng, "kv_tier", None)
            if tier is not None:
                # hierarchical KV tiering: spilled-page residency per
                # tier (host/disk) plus refusal counters — the capacity
                # story behind "resident sessions grow with host RAM"
                out["kv_tier"] = tier.stats()
        else:
            slab = getattr(eng, "_slab", None)
            if slab is not None:
                # slab rows are the closest capacity analogue
                out["free_pages"] = slab.free_slots
        sessions = getattr(eng, "sessions", None)
        if sessions is not None:
            # conversation bookkeeping: active-session count and
            # retirement breakdown (ttl vs lru)
            out["sessions"] = sessions.stats()
        spec = getattr(eng, "speculative", None)
        if spec is not None:
            # speculative decoding: acceptance stats plus the verify-
            # page accounting (transient demand-grown pages show in
            # page_pool.stats() while held; these counters prove the
            # rejected tails came back)
            out["speculative"] = spec.stats()
            out["speculative"]["pages_claimed"] = getattr(
                eng, "spec_pages_claimed", 0
            )
            out["speculative"]["pages_rolled_back"] = getattr(
                eng, "spec_pages_rolled_back", 0
            )
        transport = getattr(eng, "prefill_transport", None)
        if transport is not None:
            out["remote_prefill"] = {
                "available": transport.available(),
                "remote": getattr(eng, "remote_prefills", 0),
                "local": getattr(eng, "local_prefills", 0),
                "fallbacks": getattr(eng, "remote_prefill_fallbacks",
                                     0),
            }
        mem = getattr(eng, "memory_report", None)
        mem = mem() if callable(mem) else None
        if mem is not None:
            # the full warmed-program HBM footprint inventory (the
            # memory_lint live-range estimate per compiled program,
            # with XLA memory_analysis + drift where available)
            out["memory"] = mem
        return out

    def _handle_post(self, h):
        path = h.path.split("?", 1)[0]
        if path in ("/drain", "/undrain"):
            # rotate-out seam: stop admitting, finish in-flight, report
            # the moment the replica is idle via the status fields
            self.draining = path == "/drain"
            self._send_json(h, 200, self.health())
            return
        if path == "/reload":
            self._handle_reload(h)
            return
        if path != "/v1/generate":
            self._send_json(h, 404, {"error": "not found"})
            return
        if self.draining:
            self._send_json(
                h, 503, {"error": "rejected", "reason": "draining"}
            )
            return
        try:
            n = int(h.headers.get("Content-Length", 0))
            body = json.loads(h.rfile.read(n) or b"{}")
            ids = body["input_ids"]
            if not isinstance(ids, list) or not ids or not all(
                isinstance(t, int) for t in ids
            ):
                raise ValueError(
                    "input_ids must be a non-empty list of ints"
                )
            # Every optional field is coerced HERE so a malformed value
            # is a 400 on this request — a raw string deadline_s reaching
            # the scheduler heap would poison sweep_expired for everyone.
            kwargs = {}
            for k in ("eos_token_id", "priority"):
                if body.get(k) is not None:
                    kwargs[k] = int(body[k])
            if body.get("deadline_s") is not None:
                deadline_s = float(body["deadline_s"])
                if not math.isfinite(deadline_s) or deadline_s < 0:
                    raise ValueError(
                        "deadline_s must be a non-negative finite number"
                    )
                kwargs["deadline_s"] = deadline_s
            max_new = None
            if body.get("max_new_tokens") is not None:
                max_new = int(body["max_new_tokens"])
                if max_new < 1:
                    raise ValueError("max_new_tokens must be >= 1")
            # resolve the SLO class at the wire: unknown -> 400 right
            # here; absent -> the default class. Only an explicit field
            # is forwarded to submit (an engine without the kwarg —
            # user-supplied stub — still takes default-class traffic).
            from ..observability.slo import DEFAULT_CLASS, get_slo_registry

            slo_class = DEFAULT_CLASS
            if body.get("slo_class") is not None:
                raw = body["slo_class"]
                if not isinstance(raw, str):
                    raise ValueError("slo_class must be a string")
                slo_class = get_slo_registry().validate(raw)
                kwargs["slo_class"] = slo_class
            # conversation identity: forwarded only when present so a
            # session-less engine (user-supplied stub without the
            # kwarg) still takes plain traffic unchanged
            if body.get("session_id") is not None:
                sid = body["session_id"]
                if not isinstance(sid, str) or not sid:
                    raise ValueError(
                        "session_id must be a non-empty string"
                    )
                kwargs["session_id"] = sid
        except Exception as e:
            self._send_json(h, 400, {"error": f"bad request: {e}"})
            return
        stream = bool(body.get("stream", True))
        events = queue.Queue()  # bounded by max_new_tokens + 1

        def on_token(tok, handle):
            events.put(("token", tok))

        def on_event(handle):
            events.put(("end", handle))

        submit_args = ([[int(t) for t in ids]],)
        if max_new is not None and hasattr(self.engine, "max_seq_len"):
            submit_args = submit_args + (max_new,)
        t_recv = time.monotonic()
        # an upstream router's traceparent makes this a child server
        # span; a direct request starts a new (head-sampled) root
        ctx = parse_traceparent(h.headers.get(TRACEPARENT_HEADER))
        tr = get_tracer()
        try:
            with self._lock:
                handle = self.engine.submit(
                    *submit_args, on_token=on_token, on_event=on_event,
                    **kwargs,
                )
                # under the SAME lock the driver steps with: the engine
                # cannot admit this handle before its trace is attached
                if not handle.finished:
                    if ctx is not None:
                        handle.trace = tr.start_span(
                            "frontend.request", ctx,
                            request_id=handle.request.request_id,
                            prompt_len=handle.request.prompt_len,
                            slo_class=slo_class,
                        )
                    else:
                        handle.trace = tr.start_trace(
                            "frontend.request",
                            request_id=handle.request.request_id,
                            prompt_len=handle.request.prompt_len,
                            slo_class=slo_class,
                        )
        except TypeError as e:
            # a field the wrapped engine doesn't take is the client's
            # problem — 400, never a dropped connection
            self._send_json(h, 400, {"error": f"bad request: {e}"})
            return
        except Exception as e:
            self._send_json(h, 500, {"error": repr(e)})
            return
        if handle.status == "REJECTED":
            code = _STATUS_FOR_REASON.get(handle.reason, 400)
            self._send_json(
                h, code,
                {"error": "rejected", "reason": handle.reason},
            )
            return
        if stream:
            self._stream_response(h, handle, events, t_recv)
        else:
            self._blocking_response(h, handle, events)
        if handle.trace is not None:
            handle.trace.finish(status=handle.status,
                                tokens=len(handle.tokens))

    def _handle_reload(self, h):
        """Live weight reload over the wire: heavy work (disk reads,
        CRC verify, quantization) runs on THIS handler thread with no
        lock held — the driver keeps decoding; only the commit takes
        the lock. 200 = staged or applied, 409 = refused (torn/
        incompatible checkpoint; the engine keeps its weights)."""
        eng = self.engine
        try:
            n = int(h.headers.get("Content-Length", 0))
            body = json.loads(h.rfile.read(n) or b"{}")
            ckpt_dir = body["ckpt_dir"]
            if not isinstance(ckpt_dir, str) or not ckpt_dir:
                raise ValueError("ckpt_dir must be a non-empty string")
            version = body.get("weights_version")
        except Exception as e:
            self._send_json(h, 400, {"error": f"bad request: {e}"})
            return
        if not hasattr(eng, "prepare_reload"):
            self._send_json(h, 400, {
                "error": f"{type(eng).__name__} does not support live "
                         f"reload"})
            return
        try:
            staged = eng.prepare_reload(
                ckpt_dir, weights_version=version
            )
            if staged.ok:
                with self._lock:
                    eng.commit_reload(staged)
        except Exception as e:
            self._send_json(h, 500, {"error": repr(e)})
            return
        out = staged.to_json()
        out["applied"] = staged.applied
        out["health"] = self.health()
        self._send_json(h, 200 if staged.ok else 409, out)

    def _terminal_payload(self, handle):
        return {
            "status": handle.status,
            "reason": handle.reason,
            "tokens": list(handle.tokens),
            "prompt_len": handle.request.prompt_len,
            "ttft_s": handle.ttft,
            "weights_version": getattr(handle, "weights_version", None),
        }

    def _blocking_response(self, h, handle, events):
        deadline = time.monotonic() + self.stream_timeout_s
        while time.monotonic() < deadline:
            try:
                kind, payload = events.get(timeout=1.0)
            except queue.Empty:
                if self._stop.is_set():
                    break
                continue
            if kind == "end":
                p = self._terminal_payload(handle)
                code = 200 if handle.status == "DONE" else (
                    _STATUS_FOR_REASON.get(handle.reason, 500)
                )
                # no stream_aborts sample here: stream_aborts counts SSE
                # streams ended by a terminal error event, and a
                # "stream": false request never opened one — the outcome
                # is fully visible in the HTTP status
                self._send_json(h, code, p)
                return
        reason = (ABORT_FRONTEND_STOPPED if self._stop.is_set()
                  else ABORT_STREAM_STALL)
        self._send_json(h, 504, {"error": reason})

    def _stream_response(self, h, handle, events, t_recv):
        h.send_response(200)
        h.send_header("Content-Type", "text/event-stream")
        h.send_header("Cache-Control", "no-cache")
        h.send_header("Connection", "close")
        h.end_headers()
        self.metrics.http_requests.inc(label="200")

        def write_event(event, payload):
            h.wfile.write(
                f"event: {event}\ndata: {json.dumps(payload)}\n\n"
                .encode("utf-8")
            )
            h.wfile.flush()

        idx = 0
        last_write = None
        counted_abort = False
        tid = None if handle.trace is None else handle.trace.trace_id
        ssp = None if handle.trace is None else get_tracer().start_span(
            "frontend.stream", handle.trace
        )
        # poll in short slices so frontend stop() ends open streams
        # promptly instead of after a full stream_timeout_s of silence
        stall_at = time.monotonic() + self.stream_timeout_s
        try:
            while True:
                try:
                    kind, payload = events.get(timeout=0.25)
                except queue.Empty:
                    if self._stop.is_set():
                        reason = ABORT_FRONTEND_STOPPED
                    elif time.monotonic() >= stall_at:
                        reason = ABORT_STREAM_STALL
                    else:
                        continue
                    counted_abort = True
                    self.metrics.stream_aborts.inc(label=reason,
                                                   trace_id=tid)
                    if ssp is not None:
                        ssp.finish(tokens=idx, error=reason)
                    write_event("error", {"reason": reason,
                                          "status": handle.status})
                    return
                stall_at = time.monotonic() + self.stream_timeout_s
                if kind == "token":
                    write_event("token", {"index": idx,
                                          "token": int(payload)})
                    now = time.monotonic()
                    if idx == 0:
                        self.metrics.wire_ttft.observe(now - t_recv,
                                                       trace_id=tid)
                    elif last_write is not None:
                        self.metrics.wire_itl.observe(now - last_write)
                    last_write = now
                    idx += 1
                else:  # terminal — exactly once by the handle contract
                    p = self._terminal_payload(handle)
                    if handle.status == "DONE":
                        if ssp is not None:
                            ssp.finish(tokens=idx)
                        write_event("done", p)
                    else:
                        # the satellite fix: shed/expired requests END
                        # the open stream with the reject reason instead
                        # of hanging it
                        counted_abort = True
                        reason = (handle.reason
                                  or handle.status.lower())
                        self.metrics.stream_aborts.inc(label=reason,
                                                       trace_id=tid)
                        if ssp is not None:
                            ssp.finish(tokens=idx, error=reason)
                        write_event("error", p)
                    return
        except (BrokenPipeError, ConnectionResetError, OSError):
            # an abort counted just before its error-event write failed
            # must not produce a second client_disconnect sample
            if not counted_abort:
                self.metrics.stream_aborts.inc(
                    label=ABORT_CLIENT_DISCONNECT, trace_id=tid,
                )
            if ssp is not None:
                ssp.finish(tokens=idx, error=ABORT_CLIENT_DISCONNECT)


# --------------------------------------------------------- client helpers
def read_sse_events(fp):
    """Parse an SSE byte stream (a ``http.client`` response file) into
    ``(event, data_dict)`` pairs — the client half the bench, the smoke
    gate and the tests share."""
    event, data = None, []
    for raw in fp:
        line = raw.decode("utf-8").rstrip("\n")
        if not line:
            if event is not None:
                yield event, json.loads("\n".join(data) or "null")
            event, data = None, []
            continue
        if line.startswith(":"):
            continue  # comment/keepalive
        if line.startswith("event:"):
            event = line[6:].strip()
        elif line.startswith("data:"):
            data.append(line[5:].strip())
    if event is not None and data:
        yield event, json.loads("\n".join(data))


def stream_generate(host, port, payload, timeout=300.0):
    """POST ``payload`` to ``/v1/generate`` and consume the SSE stream.

    Returns ``(events, timings)`` where ``events`` is the parsed
    ``(event, data)`` list and ``timings`` carries client-measured
    ``ttft_s`` / per-gap ``itl_s`` (wire latency as the CLIENT sees it —
    serve_bench reports these next to the engine's in-process numbers).
    Raises ``HTTPRejected`` with ``.code``/``.body`` on a non-200."""
    import http.client

    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    t0 = time.monotonic()
    conn.request(
        "POST", "/v1/generate", body=json.dumps(payload),
        headers={"Content-Type": "application/json"},
    )
    resp = conn.getresponse()
    if resp.status != 200:
        body = resp.read().decode("utf-8", "replace")
        conn.close()
        err = HTTPRejected(f"HTTP {resp.status}: {body}")
        err.code = resp.status
        try:
            err.body = json.loads(body)
        except Exception:
            err.body = {"raw": body}
        raise err
    events, itl, ttft, last = [], [], None, None
    for event, data in read_sse_events(resp):
        now = time.monotonic()
        if event == "token":
            if ttft is None:
                ttft = now - t0
            elif last is not None:
                itl.append(now - last)
            last = now
        events.append((event, data))
        if event in ("done", "error"):
            break
    conn.close()
    return events, {"ttft_s": ttft, "itl_s": itl}


class HTTPRejected(RuntimeError):
    """Non-200 response from the front-end; ``.code`` and ``.body``."""
