"""Occupancy-aware replica router — the fleet's front door (the port of
``paddle_tpu/serving/fleet/router.py``: host code only, over the port's
``serving/httpd.py`` and ``observability/``; the JAX package's opt-in
lock sentinel, ``maybe_instrument``, waits with ``ROADMAP.md`` queue A
item 7).

One :class:`~..http_frontend.ServingFrontend` serves one engine; at the
millions-of-users north star the unit of scaling is a FLEET of them.
:class:`FleetRouter` is a stdlib-HTTP front-end with the same wire
surface (``POST /v1/generate`` -> SSE token stream) that places each
request on the best replica:

- **Admission signal**: a scrape loop polls every replica's
  machine-readable ``/healthz`` status (free pages, queue depth,
  in-flight, draining, generation) and publishes it as per-replica
  gauges. Placement picks the eligible replica with the LOWEST load
  score ``(1 + queue_depth + active + routed_in_flight) / (1 +
  free_pages)`` — free pages are capacity, queue depth is pressure,
  and the router's own in-flight count covers scrape staleness.
- **Cache affinity**: replicas running a prefix cache (the paged
  engine's COW page sharing) serve a warm prefix with near-zero
  prefill compute and near-zero marginal HBM — but only on the
  replica that already holds the pages. The router remembers which
  replica last served each prompt-prefix head (first
  ``affinity_prefix_tokens`` input ids, bounded LRU map) and divides
  that replica's load score by ``1 + affinity_bonus``: same-prefix
  traffic converges onto the warm replica until real load outweighs
  the bonus. Recorded at placement time so concurrent same-prefix
  requests converge immediately.
- **Circuit breaking**: request-path failures (connect errors, 5xx)
  count per replica; past ``breaker_threshold`` consecutive failures
  the breaker OPENS for ``breaker_cooldown_s`` (placement skips it),
  then half-opens for one fresh attempt. A success closes it.
- **Bounded retry of UNSTARTED requests**: a request that failed
  before its first token event (connect refused, replica 429/503,
  mid-handshake death) is retried on the next-best replica, each
  eligible replica tried at most once. A request that already
  streamed tokens is NEVER replayed — its stream ends with a terminal
  ``event: error`` carrying the reason (``replica_failed``), because
  re-running a partially-streamed decode would duplicate tokens.
- **Shed with reason**: when every eligible replica rejects with
  backpressure the client gets HTTP 429 ``{"reason":
  "fleet_saturated"}`` BEFORE any stream opens; an empty/unhealthy
  fleet sheds 503 ``no_replicas``; all-connect-failures sheds 502
  ``replicas_unavailable``.
- **Aggregated /metrics**: the router's process registry exposition
  carries the routing counters AND the per-replica health series
  (``paddle_fleet_replica_{healthy,free_pages,queue_depth,active}``),
  so one scrape shows the whole fleet.

Admin surface: ``GET /replicas`` (full status JSON), ``POST
/admin/drain/<i>`` / ``/admin/undrain/<i>`` proxy the replica's drain
toggle and immediately stop/resume routing to it — rotate a replica
out with zero dropped requests.
"""
from __future__ import annotations

import collections
import json
import threading
import time

from ...observability import Gauge, get_registry
from ...observability.exporter import prometheus_text
from ...observability.tracing import (
    TRACEPARENT_HEADER,
    Tracer,
    format_traceparent,
    trace_payload,
)
from ..metrics import Counter, Histogram

# terminal stream-abort reasons the router originates
ABORT_REPLICA_FAILED = "replica_failed"
ABORT_CLIENT_DISCONNECT = "client_disconnect"

SHED_FLEET_SATURATED = "fleet_saturated"
SHED_NO_REPLICAS = "no_replicas"
SHED_REPLICAS_UNAVAILABLE = "replicas_unavailable"

_SHED_STATUS = {
    SHED_FLEET_SATURATED: 429,
    SHED_NO_REPLICAS: 503,
    SHED_REPLICAS_UNAVAILABLE: 502,
}


class RouterMetrics:
    """The router's registry instruments: routing counters + the
    per-replica health gauges the scrape loop feeds."""

    def __init__(self, registry=None, namespace="paddle_fleet"):
        ns = namespace
        self.requests = Counter(
            "fleet_requests", labelname="replica",
            prom_name=f"{ns}_requests_total",
            help="requests routed, by replica index")
        self.http_requests = Counter(
            "fleet_http_requests", labelname="code",
            prom_name=f"{ns}_http_requests_total",
            help="router HTTP responses, by status code")
        self.retries = Counter(
            "fleet_retries", labelname="reason",
            prom_name=f"{ns}_retries_total",
            help="unstarted requests retried on another replica, by "
                 "trigger")
        self.shed = Counter(
            "fleet_shed", labelname="reason",
            prom_name=f"{ns}_shed_total",
            help="requests shed by the router, by reason")
        self.breaker_opens = Counter(
            "fleet_breaker_opens", labelname="replica",
            prom_name=f"{ns}_breaker_opens_total",
            help="circuit-breaker opens, by replica index")
        self.stream_aborts = Counter(
            "fleet_stream_aborts", labelname="reason",
            prom_name=f"{ns}_stream_aborts_total",
            help="router-side streams ended by a terminal error event")
        self.ttft = Histogram(
            "fleet_ttft", prom_name=f"{ns}_router_ttft_seconds",
            help="router-received to first token byte forwarded")
        self.replica_healthy = Gauge(
            "fleet_replica_healthy",
            prom_name=f"{ns}_replica_healthy",
            help="1 when the replica's last status scrape succeeded")
        self.replica_free_pages = Gauge(
            "fleet_replica_free_pages",
            prom_name=f"{ns}_replica_free_pages",
            help="free KV pages from the replica's last status")
        self.replica_queue_depth = Gauge(
            "fleet_replica_queue_depth",
            prom_name=f"{ns}_replica_queue_depth",
            help="scheduler queue depth from the replica's last status")
        self.replica_active = Gauge(
            "fleet_replica_active",
            prom_name=f"{ns}_replica_active",
            help="in-flight decode rows from the replica's last status")
        self.replica_prefix_hits = Gauge(
            "fleet_replica_prefix_hits",
            prom_name=f"{ns}_replica_prefix_hits",
            help="prefix-cache hits from the replica's last status "
                 "(absent series = replica runs no prefix cache)")
        self.replica_alerts = Gauge(
            "fleet_replica_alerts_active",
            prom_name=f"{ns}_replica_alerts_active",
            help="1 while the replica reports this burn-rate alert "
                 "active in its /healthz alerts block, 0 once cleared "
                 "(labels: replica, rule, slo_class)")
        reg = registry or get_registry()
        reg.register_all([
            self.requests, self.http_requests, self.retries, self.shed,
            self.breaker_opens, self.stream_aborts, self.ttft,
            self.replica_healthy, self.replica_free_pages,
            self.replica_queue_depth, self.replica_active,
            self.replica_prefix_hits, self.replica_alerts,
        ])


class ReplicaState:
    """Router-side view of one replica."""

    def __init__(self, index, host, port):
        self.index = index
        self.host = host
        self.port = int(port)
        self.status = None          # last /healthz JSON
        self.status_time = 0.0
        self.healthy = False
        self.draining = False
        self.in_flight = 0          # router-side routed-not-finished
        self.failures = 0           # consecutive request-path failures
        self.breaker_open_until = 0.0
        self.requests_routed = 0
        # (rule, slo_class) pairs seen active in the last scrape — the
        # set difference drives 1 -> 0 gauge transitions on clear
        self.alert_keys = set()

    @property
    def url(self):
        return f"http://{self.host}:{self.port}"

    def summary(self, now):
        st = self.status or {}
        return {
            "index": self.index,
            "host": self.host,
            "port": self.port,
            "healthy": self.healthy,
            "draining": self.draining,
            "breaker_open": now < self.breaker_open_until,
            "in_flight_routed": self.in_flight,
            "requests_routed": self.requests_routed,
            "status_age_s": (None if not self.status_time
                             else round(now - self.status_time, 3)),
            "free_pages": st.get("free_pages"),
            "queue_depth": st.get("queue_depth"),
            "active": st.get("active"),
            "generation": st.get("generation"),
            "weights_version": st.get("weights_version"),
            "last_reload_step": st.get("last_reload_step"),
            "reload_in_progress": st.get("reload_in_progress"),
            "compile_cache_hits": st.get("compile_cache_hits"),
            "prefix_cache": st.get("prefix_cache"),
            "alerts": st.get("alerts"),
        }


def _parse_replica(spec):
    if isinstance(spec, (tuple, list)):
        return str(spec[0]), int(spec[1])
    host, _, port = str(spec).rpartition(":")
    return (host or "127.0.0.1"), int(port)


class FleetRouter:
    """Route ``/v1/generate`` across N engine replicas.

    ``replicas`` is a list of ``(host, port)`` pairs or
    ``"host:port"`` strings — each the address of a
    :class:`~..http_frontend.ServingFrontend`. ``port=0`` binds the
    router on an ephemeral port (read ``.port`` back)."""

    def __init__(self, replicas, *, host="127.0.0.1", port=0,
                 registry=None, health_interval_s=0.25,
                 status_ttl_s=3.0, breaker_threshold=3,
                 breaker_cooldown_s=2.0, connect_timeout_s=5.0,
                 stream_timeout_s=120.0, clock=time.monotonic,
                 watch_ckpt_root=None, watch_interval_s=1.0,
                 watch_drain_timeout_s=120.0, affinity_bonus=0.5,
                 affinity_prefix_tokens=32, affinity_map_size=4096):
        if not replicas:
            raise ValueError("FleetRouter needs at least one replica")
        self.replicas = [
            ReplicaState(i, *_parse_replica(s))
            for i, s in enumerate(replicas)
        ]
        self.host = host
        self.port = int(port)
        self.metrics = RouterMetrics(registry=registry)
        self.health_interval_s = float(health_interval_s)
        self.status_ttl_s = float(status_ttl_s)
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_cooldown_s = float(breaker_cooldown_s)
        self.connect_timeout_s = float(connect_timeout_s)
        self.stream_timeout_s = float(stream_timeout_s)
        self.clock = clock
        # cache-affinity placement: prompt-prefix head -> replica index
        # that last served it (bounded LRU; a prefix-cache hit there is
        # near-free, so its load score earns a bonus)
        self.affinity_bonus = float(affinity_bonus)
        self.affinity_prefix_tokens = int(affinity_prefix_tokens)
        self.affinity_map_size = int(affinity_map_size)
        self._affinity = collections.OrderedDict()
        # the router owns its OWN tracer (not the process default): it
        # must show up as a distinct "router" process row even when it
        # runs in-process next to an engine (serve_bench, smokes)
        self.tracer = Tracer(process="router")
        self._lock = threading.Lock()
        # one rolling reload at a time: overlapping walks would drain
        # multiple replicas at once, breaking the at-most-one-out-of-
        # rotation invariant (a retried admin POST must get a 409, not
        # a second concurrent walk)
        self._reload_walk_lock = threading.Lock()
        self._stop = threading.Event()
        self._httpd = None
        self._http_thread = None
        self._scrape_thread = None
        # checkpoint-root auto-rotation: poll latest_committed and run
        # the rolling walk on a NEW commit — publishing a checkpoint
        # then needs zero admin POSTs
        self.watch_ckpt_root = (
            str(watch_ckpt_root) if watch_ckpt_root else None
        )
        self.watch_interval_s = float(watch_interval_s)
        self.watch_drain_timeout_s = float(watch_drain_timeout_s)
        self._watch_thread = None
        self._watched_step = None
        self.last_watch_result = None

    # ---------------------------------------------------------- lifecycle
    def start(self):
        from ..httpd import start_http_server

        # one synchronous scrape first, so the router can place
        # requests the moment start() returns
        self._scrape_all()
        self._httpd, self._http_thread = start_http_server(
            self.host, self.port, self._handle_get, self._handle_post,
            name="paddle-fleet-http",
        )
        self.port = self._httpd.server_address[1]
        self._scrape_thread = threading.Thread(
            target=self._scrape_loop, name="paddle-fleet-scrape",
            daemon=True,
        )
        self._scrape_thread.start()
        if self.watch_ckpt_root:
            # baseline = the newest commit ALREADY on disk: the fleet
            # is assumed launched from it, only new commits rotate
            found = self._latest_commit()
            with self._lock:
                self._watched_step = found[0] if found else None
            self._watch_thread = threading.Thread(
                target=self._watch_ckpt_loop,
                name="paddle-fleet-ckpt-watch", daemon=True,
            )
            self._watch_thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._scrape_thread is not None:
            self._scrape_thread.join(timeout=5)
            self._scrape_thread = None
        if self._watch_thread is not None:
            self._watch_thread.join(timeout=5)
            self._watch_thread = None
        from ..httpd import stop_http_server

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

    # ------------------------------------------------------------- scrape
    def _scrape_one(self, r):
        import http.client

        try:
            conn = http.client.HTTPConnection(
                r.host, r.port, timeout=max(self.health_interval_s, 1.0)
            )
            conn.request("GET", "/healthz")
            resp = conn.getresponse()
            body = resp.read()
            conn.close()
            if resp.status != 200:
                raise OSError(f"healthz HTTP {resp.status}")
            status = json.loads(body)
        except (OSError, ValueError) as e:
            with self._lock:
                r.healthy = False
                r.status_time = self.clock()
                r.status = {"error": repr(e)}
            self.metrics.replica_healthy.set(0, replica=str(r.index))
            return
        with self._lock:
            r.status = status
            r.status_time = self.clock()
            r.healthy = bool(status.get("accepting", True))
            r.draining = bool(status.get("draining", False))
        m = self.metrics
        idx = str(r.index)
        m.replica_healthy.set(1 if r.healthy else 0, replica=idx)
        for gauge, field in (
            (m.replica_free_pages, "free_pages"),
            (m.replica_queue_depth, "queue_depth"),
            (m.replica_active, "active"),
        ):
            v = status.get(field)
            if v is not None:
                gauge.set(float(v), replica=idx)
        hits = (status.get("prefix_cache") or {}).get("hits")
        if hits is not None:
            m.replica_prefix_hits.set(float(hits), replica=idx)
        # burn-rate alert aggregation: mirror the replica's active set
        # into the router gauge, clearing (1 -> 0) series that vanished
        active = (status.get("alerts") or {}).get("active") or []
        keys = set()
        for a in active:
            if not isinstance(a, dict):
                continue
            key = (str(a.get("rule")), str(a.get("slo_class")))
            keys.add(key)
        with self._lock:
            prev, r.alert_keys = r.alert_keys, keys
        for rule, cls in keys:
            m.replica_alerts.set(1, replica=idx, rule=rule,
                                 slo_class=cls)
        for rule, cls in prev - keys:
            m.replica_alerts.set(0, replica=idx, rule=rule,
                                 slo_class=cls)

    def _scrape_all(self):
        # one thread per replica: a few unreachable hosts hanging to
        # their connect timeout must not age every HEALTHY replica's
        # status past status_ttl_s (serial scraping would shed the
        # whole fleet as stale)
        threads = [
            threading.Thread(target=self._scrape_one, args=(r,),
                             daemon=True)
            for r in self.replicas
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    def _scrape_loop(self):
        while not self._stop.wait(self.health_interval_s):
            self._scrape_all()

    # ---------------------------------------------------------- placement
    def _eligible(self, now, exclude=()):
        return [r for r, _ in self._eligible_snapshot(now, exclude)]

    def _eligible_snapshot(self, now, exclude=()):
        """Eligible replicas WITH their load-score inputs, all read
        under the lock: the scrape thread rewrites ``r.status`` /
        ``r.healthy`` concurrently, and scoring from unlocked reads
        mixes fields of two different scrapes (the health-map race the
        concurrency lint flags)."""
        out = []
        with self._lock:
            for r in self.replicas:
                if r.index in exclude:
                    continue
                if not r.healthy or r.draining:
                    continue
                if now < r.breaker_open_until:
                    continue
                if now - r.status_time > self.status_ttl_s:
                    continue
                st = r.status or {}
                out.append((r, (
                    float(st.get("queue_depth") or 0)
                    + float(st.get("active") or 0)
                    + float(r.in_flight),
                    float(st.get("free_pages") or 0),
                )))
        return out

    def _affinity_key(self, parsed):
        """Cache-affinity placement key: the session id when the body
        carries one (every turn of a chat lands on the replica holding
        its decode-published KV chain), else the prompt-prefix head
        (None when the body carries no usable input_ids)."""
        if isinstance(parsed, dict):
            sid = parsed.get("session_id")
            if isinstance(sid, str) and sid:
                return ("session", sid)
        ids = parsed.get("input_ids") if isinstance(parsed, dict) else None
        if not isinstance(ids, list) or not ids:
            return None
        try:
            return tuple(int(t) for t in
                         ids[:self.affinity_prefix_tokens])
        except (TypeError, ValueError):
            return None

    def _note_affinity(self, key, index):
        if key is None or self.affinity_bonus <= 0:
            return
        with self._lock:
            self._affinity[key] = index
            self._affinity.move_to_end(key)
            while len(self._affinity) > self.affinity_map_size:
                self._affinity.popitem(last=False)

    def _pick(self, exclude=(), affinity_key=None):
        """Least-loaded eligible replica, or None. Load folds the
        scraped queue depth + active rows (pressure) against free
        pages (capacity), plus the router's own in-flight count so two
        back-to-back requests don't pile onto one replica between
        scrapes. The replica that last served this prompt-prefix head
        gets its score divided by ``1 + affinity_bonus`` — a warm
        prefix cache makes it strictly cheaper there, until real load
        outweighs the bonus."""
        now = self.clock()
        affine = None
        if affinity_key is not None and self.affinity_bonus > 0:
            with self._lock:
                affine = self._affinity.get(affinity_key)
        best, best_score = None, None
        for r, (pressure0, free_pages) in self._eligible_snapshot(
            now, exclude
        ):
            pressure = 1.0 + pressure0
            capacity = 1.0 + free_pages
            score = pressure / capacity
            if affine == r.index:
                score /= 1.0 + self.affinity_bonus
            if best_score is None or score < best_score:
                best, best_score = r, score
        return best

    def _breaker_fail(self, r):
        with self._lock:
            r.failures += 1
            r.healthy = False  # next scrape may resurrect it
            if r.failures >= self.breaker_threshold:
                r.breaker_open_until = (self.clock()
                                        + self.breaker_cooldown_s)
                r.failures = 0
                opened = True
            else:
                opened = False
        self.metrics.replica_healthy.set(0, replica=str(r.index))
        if opened:
            self.metrics.breaker_opens.inc(label=str(r.index))

    def _breaker_ok(self, r):
        with self._lock:
            r.failures = 0
            r.breaker_open_until = 0.0

    # ----------------------------------------------------------- handlers
    def _send_json(self, h, code, obj):
        from ..httpd import send_json

        try:
            send_json(h, code, obj)
        except OSError:
            return
        self.metrics.http_requests.inc(label=str(code))

    def _handle_get(self, h):
        from ..httpd import send_text

        path = h.path.split("?", 1)[0]
        try:
            if path == "/metrics":
                send_text(
                    h, 200, prometheus_text().encode("utf-8"),
                    "text/plain; version=0.0.4; charset=utf-8",
                )
                self.metrics.http_requests.inc(label="200")
            elif path == "/trace":
                self._send_json(h, 200, trace_payload(self.tracer))
            elif path == "/alerts":
                # fleet-wide SLO view: every replica's active alert
                # block from the last /healthz scrape, in one response
                with self._lock:
                    reps = [
                        {
                            "index": r.index,
                            "host": r.host,
                            "port": r.port,
                            "alerts": (r.status or {}).get("alerts"),
                        }
                        for r in self.replicas
                    ]
                total = sum(
                    len(((rep["alerts"] or {}).get("active")) or [])
                    for rep in reps
                )
                self._send_json(h, 200, {
                    "role": "fleet-router",
                    "active_total": total,
                    "replicas": reps,
                })
            elif path in ("/healthz", "/replicas"):
                now = self.clock()
                reps = [r.summary(now) for r in self.replicas]
                self._send_json(h, 200, {
                    "role": "fleet-router",
                    "replicas": reps,
                    "eligible": len(self._eligible(now)),
                })
            else:
                self._send_json(h, 404, {"error": "not found"})
        except Exception as e:
            try:
                self._send_json(h, 500, {"error": repr(e)})
            except Exception:
                pass

    def _handle_post(self, h):
        path = h.path.split("?", 1)[0]
        if path.startswith("/admin/drain/") \
                or path.startswith("/admin/undrain/"):
            self._handle_admin_drain(h, path)
            return
        if path == "/admin/reload":
            self._handle_admin_reload(h)
            return
        if path != "/v1/generate":
            self._send_json(h, 404, {"error": "not found"})
            return
        try:
            n = int(h.headers.get("Content-Length", 0))
            body = h.rfile.read(n) or b"{}"
            parsed = json.loads(body)
            if not isinstance(parsed, dict):
                raise ValueError("body must be a JSON object")
        except Exception as e:
            self._send_json(h, 400, {"error": f"bad request: {e}"})
            return
        stream = bool(parsed.get("stream", True))
        try:
            self._route(h, body, stream, parsed)
        except Exception as e:
            # last-ditch: the client must get a status or a terminal
            # event, never a silently dropped connection
            try:
                self._send_json(h, 502, {"error": repr(e)})
            except Exception:
                pass

    def _handle_admin_drain(self, h, path):
        import http.client

        undo = path.startswith("/admin/undrain/")
        try:
            idx = int(path.rsplit("/", 1)[1])
            r = self.replicas[idx]
        except (ValueError, IndexError):
            self._send_json(h, 404, {"error": "no such replica"})
            return
        try:
            conn = http.client.HTTPConnection(
                r.host, r.port, timeout=self.connect_timeout_s
            )
            conn.request("POST", "/undrain" if undo else "/drain")
            resp = conn.getresponse()
            body = resp.read()
            conn.close()
            replica_resp = json.loads(body or b"{}")
        except (OSError, ValueError) as e:
            self._send_json(h, 502, {"error": repr(e),
                                     "replica": idx})
            return
        # stop/resume routing immediately; the scrape loop keeps the
        # flag in sync with the replica's own report afterwards
        with self._lock:
            r.draining = not undo
        self._send_json(h, 200, {"replica": idx,
                                 "draining": not undo,
                                 "replica_response": replica_resp})

    # ----------------------------------------------------- rolling reload
    def _replica_call(self, r, method, path, body=None, timeout=None):
        """One HTTP exchange with a replica; raises OSError-family on
        transport trouble. Returns ``(status, parsed_json)``."""
        import http.client

        conn = http.client.HTTPConnection(
            r.host, r.port,
            timeout=timeout if timeout is not None
            else self.connect_timeout_s,
        )
        try:
            payload = None if body is None else json.dumps(body)
            conn.request(
                method, path, body=payload,
                headers={"Content-Type": "application/json"}
                if payload is not None else {},
            )
            resp = conn.getresponse()
            raw = resp.read()
        finally:
            conn.close()
        try:
            parsed = json.loads(raw or b"{}")
        except ValueError:
            parsed = {"raw": raw.decode("utf-8", "replace")}
        return resp.status, parsed

    def _reload_replica(self, r, ckpt_dir, version, drain_timeout_s):
        """drain -> wait idle -> /reload -> undrain, for one replica.
        The undrain runs in ``finally`` so a failed reload leaves the
        replica back in rotation (on its OLD weights) instead of
        silently out of the fleet."""
        import http.client

        _err = (OSError, http.client.HTTPException)
        out = {"replica": r.index, "ok": False}
        # a replica the operator ALREADY drained (maintenance, debug)
        # stays drained after its reload — the walk only undoes its
        # own drain, never a deliberate prior one. When the probe
        # itself fails, fall back to the router's own view (the scrape
        # loop mirrors the replica's flag) rather than assuming False
        # and undraining a deliberately-removed replica.
        try:
            _, st0 = self._replica_call(r, "GET", "/healthz")
            was_draining = bool(st0.get("draining", False))
        except _err:
            was_draining = bool(r.draining)
        with self._lock:
            r.draining = True
        try:
            # the drain POST runs INSIDE the undrain guard: if it was
            # applied but its response got lost, the finally still
            # puts the replica back in rotation (an undrain the
            # replica never needed is harmless)
            try:
                self._replica_call(r, "POST", "/drain")
            except _err as e:
                out.update(stage="drain", error=repr(e))
                return out
            # admin-walk deadline on REAL time: the injectable clock
            # drives placement/breaker logic (tests advance it
            # manually), and pacing below sleeps real seconds — mixing
            # the two would make the timeout unreachable
            deadline = time.monotonic() + float(drain_timeout_s)
            idle = False
            while time.monotonic() < deadline:
                if self._stop.is_set():
                    # router shutting down mid-walk: unwind NOW so the
                    # finally below undrains this replica before the
                    # process exits — a drain-wait that outlives
                    # stop()'s join would strand it out of rotation
                    out.update(stage="router_stopped",
                               error="router stopped during drain wait")
                    return out
                try:
                    _, st = self._replica_call(r, "GET", "/healthz")
                except _err:
                    st = {}
                if (st.get("active", 1) == 0
                        and st.get("queue_depth", 1) == 0):
                    idle = True
                    break
                time.sleep(0.05)
            if not idle:
                out.update(stage="drain_timeout",
                           error=f"replica {r.index} not idle within "
                                 f"{drain_timeout_s}s")
                return out
            try:
                # reload prepare reads + verifies the checkpoint from
                # disk — give it the stream budget, not the connect one
                code, res = self._replica_call(
                    r, "POST", "/reload",
                    body={"ckpt_dir": ckpt_dir,
                          "weights_version": version},
                    timeout=self.stream_timeout_s,
                )
            except _err as e:
                out.update(stage="reload", error=repr(e))
                return out
            if code != 200 or not res.get("ok", False):
                out.update(stage="reload", status=code,
                           error=res.get("error") or res)
                out["outcome"] = res.get("outcome")
                return out
            out.update(
                ok=True, outcome=res.get("outcome"),
                weights_version=res.get("weights_version"),
                step=res.get("step"), applied=res.get("applied"),
            )
            return out
        finally:
            if was_draining:
                out["kept_drained"] = True
            else:
                try:
                    self._replica_call(r, "POST", "/undrain")
                except _err as e:
                    # a replica stuck draining IS a failed rotation
                    # step: the walk must STOP (out is mutated after
                    # the return — the caller sees ok=False), or it
                    # would drain the next replica with this one
                    # still out of rotation
                    out["undrain_error"] = repr(e)
                    out["ok"] = False
                    out.setdefault("stage", "undrain")
                with self._lock:
                    r.draining = False
                # re-scrape NOW: the walk must not drain the next
                # replica while this one still carries its stale
                # draining/unhealthy status — that window is the one
                # place a 2-replica rotation could shed no_replicas
                self._scrape_one(r)

    def _handle_admin_reload(self, h):
        """``POST /admin/reload {"ckpt_dir": ...}`` — the zero-downtime
        rotation: walk the fleet one replica at a time, drain -> swap
        -> undrain. At most ONE replica is ever out of rotation, so
        in-flight streams finish where they run and new requests place
        on the rest of the fleet — zero dropped requests. Stops at the
        first failed replica (a bad checkpoint must not take the whole
        fleet); already-rotated replicas keep the new weights, the
        failed one is undrained on its old weights."""
        try:
            n = int(h.headers.get("Content-Length", 0))
            body = json.loads(h.rfile.read(n) or b"{}")
            ckpt_dir = body["ckpt_dir"]
            if not isinstance(ckpt_dir, str) or not ckpt_dir:
                raise ValueError("ckpt_dir must be a non-empty string")
            version = body.get("weights_version")
            drain_timeout_s = float(body.get("drain_timeout_s", 120.0))
        except Exception as e:
            self._send_json(h, 400, {"error": f"bad request: {e}"})
            return
        out = self.reload_fleet(ckpt_dir, version=version,
                                drain_timeout_s=drain_timeout_s)
        if out is None:
            self._send_json(h, 409, {
                "error": "rejected",
                "reason": "reload_in_progress",
            })
            return
        self._send_json(h, 200 if out["ok"] else 500, out)

    def reload_fleet(self, ckpt_dir, version=None,
                     drain_timeout_s=120.0):
        """Run one rolling reload walk (drain -> swap -> undrain, one
        replica at a time — the ``/admin/reload`` body). Returns the
        ``{"ok": ..., "results": [...]}`` record, or None when a walk
        is already in progress (the admin handler maps that to 409,
        the checkpoint watcher just retries on its next poll)."""
        if not self._reload_walk_lock.acquire(blocking=False):
            return None
        try:
            results = []
            for r in self.replicas:
                res = self._reload_replica(r, ckpt_dir, version,
                                           drain_timeout_s)
                results.append(res)
                if not res["ok"]:
                    break
            ok = all(res["ok"] for res in results) and \
                len(results) == len(self.replicas)
        finally:
            self._reload_walk_lock.release()
        return {"ok": ok, "results": results}

    # ------------------------------------------------ checkpoint watching
    def _latest_commit(self):
        """Newest COMMITTED checkpoint under the watched root as
        ``(step, path)``, or None. Manifest-committed generations only
        (``latest_committed`` — a torn/in-flight save can never
        trigger a rotation)."""
        from ...checkpoint import commit as commit_mod

        try:
            path = commit_mod.latest_committed(self.watch_ckpt_root)
            if path is None:
                return None
            manifest = commit_mod.read_manifest(path)
            if manifest is None:
                return None
            return int(manifest["step"]), path
        except Exception:
            return None

    def _watch_ckpt_loop(self):
        while not self._stop.wait(self.watch_interval_s):
            found = self._latest_commit()
            if found is None:
                continue
            step, path = found
            with self._lock:
                watched = self._watched_step
            if watched is not None and step <= watched:
                continue
            out = self.reload_fleet(
                path, version=None,
                drain_timeout_s=self.watch_drain_timeout_s,
            )
            if out is None:
                continue  # a walk was in flight; retry next poll
            # watcher-thread publications go under the lock: admin
            # readers (/replicas, tests) poll these from other threads
            with self._lock:
                self.last_watch_result = dict(out, step=step, path=path)
                if out["ok"]:
                    # only a fully-rotated fleet advances the marker: a
                    # failed walk is retried on the next poll (replicas
                    # already rotated are version-idempotent)
                    self._watched_step = step

    # ------------------------------------------------------------ routing
    def _route(self, h, body, stream, parsed=None):
        # head-sampling point for the whole distributed trace: the root
        # span starts here (or not at all); everything downstream —
        # frontend, engine, KV wire, worker — hangs off its context
        rsp = self.tracer.start_trace("router.request",
                                      stream=bool(stream))
        try:
            attrs = self._route_attempts(h, body, stream, parsed, rsp)
        except BaseException:
            if rsp is not None:
                rsp.finish(outcome="error", error="router_error")
            raise
        if rsp is not None:
            rsp.finish(**attrs)

    def _route_attempts(self, h, body, stream, parsed, rsp):
        """The placement/retry loop; returns the root span's outcome
        attributes (``error=`` present on shed/abort paths)."""
        t_recv = self.clock()
        tried = set()
        saw_saturated = False
        saw_conn_error = False
        akey = self._affinity_key(parsed or {})
        tid = None if rsp is None else rsp.trace_id
        client = _ClientStream(h, self.metrics, trace_id=tid)
        while True:
            r = self._pick(exclude=tried, affinity_key=akey)
            if r is None:
                break
            tried.add(r.index)
            # recorded at placement, not completion: concurrent
            # same-prefix requests converge on the warm replica now
            self._note_affinity(akey, r.index)
            with self._lock:
                r.in_flight += 1
            try:
                outcome = self._try_replica(r, client, body, stream,
                                            t_recv, rsp)
            finally:
                with self._lock:
                    r.in_flight -= 1
            if outcome == "done":
                self._breaker_ok(r)
                return {"outcome": "done", "replica": r.index,
                        "attempts": len(tried)}
            if outcome == "client_gone":
                return {"outcome": "client_gone", "replica": r.index,
                        "attempts": len(tried),
                        "error": ABORT_CLIENT_DISCONNECT}
            if outcome == "failed_after_tokens":
                # terminal error already sent; never replayed
                self._breaker_fail(r)
                return {"outcome": "failed_after_tokens",
                        "replica": r.index, "attempts": len(tried),
                        "error": ABORT_REPLICA_FAILED}
            if outcome == "saturated":
                saw_saturated = True
                self.metrics.retries.inc(label="replica_busy",
                                         trace_id=tid)
                continue
            if outcome in ("conn_error", "midstream_unstarted"):
                # midstream_unstarted already counted its retry label
                # in _pipe_sse — one retry event, one sample
                saw_conn_error = True
                self._breaker_fail(r)
                if outcome == "conn_error":
                    self.metrics.retries.inc(label="conn_error",
                                             trace_id=tid)
                continue
            raise AssertionError(f"unknown outcome {outcome!r}")
        # fleet exhausted: shed with a reason that tells the client
        # (and the load balancer above us) what to do about it
        if saw_saturated:
            reason = SHED_FLEET_SATURATED
        elif saw_conn_error:
            reason = SHED_REPLICAS_UNAVAILABLE
        else:
            reason = SHED_NO_REPLICAS
        self.metrics.shed.inc(label=reason, trace_id=tid)
        if client.headers_sent:
            # stream already open (a replica died mid-handshake after
            # we committed to SSE): terminal error event, not a status
            self.metrics.stream_aborts.inc(label=reason, trace_id=tid)
            client.error_event({"reason": reason})
        else:
            self._send_json(h, _SHED_STATUS[reason], {
                "error": "rejected", "reason": reason,
                "replicas_tried": len(tried),
            })
        return {"outcome": "shed", "attempts": len(tried),
                "error": reason}

    def _try_replica(self, r, client, body, stream, t_recv, rsp=None):
        """One placement attempt. Returns 'done' | 'client_gone' |
        'failed_after_tokens' | 'saturated' | 'conn_error' |
        'midstream_unstarted'."""
        # per-attempt CLIENT span — its traceparent is what crosses the
        # HTTP hop, so the replica's server span parents under THIS
        # attempt, not under the whole request (retries stay separable)
        asp = None if rsp is None else self.tracer.start_span(
            "router.try_replica", rsp, replica=r.index
        )
        outcome = self._try_replica_once(r, client, body, stream,
                                         t_recv, asp)
        if asp is not None:
            bad = outcome in ("conn_error", "midstream_unstarted",
                              "failed_after_tokens", "saturated",
                              "client_gone")
            asp.finish(outcome=outcome,
                       **({"error": outcome} if bad else {}))
        return outcome

    def _try_replica_once(self, r, client, body, stream, t_recv, asp):
        import http.client

        # a replica dying mid-response surfaces as HTTPException
        # (BadStatusLine, IncompleteRead) — NOT an OSError subclass;
        # both mean the same thing here: replica trouble, retryable
        # while nothing reached the client
        _replica_err = (OSError, http.client.HTTPException)
        conn = http.client.HTTPConnection(
            r.host, r.port, timeout=self.connect_timeout_s
        )
        try:
            headers = {"Content-Type": "application/json"}
            if asp is not None:
                headers[TRACEPARENT_HEADER] = format_traceparent(asp)
            conn.request(
                "POST", "/v1/generate", body=body, headers=headers,
            )
            # connect is bounded by connect_timeout_s above; from here
            # on reads wait on GENERATION (a non-stream response only
            # arrives when decode finishes), so the stream timeout
            # governs — for every branch, not just SSE piping
            if conn.sock is not None:
                conn.sock.settimeout(self.stream_timeout_s)
            resp = conn.getresponse()
        except _replica_err:
            conn.close()
            return "conn_error"
        try:
            if resp.status != 200:
                try:
                    payload = resp.read()
                except _replica_err:
                    return "conn_error"
                if resp.status in (429, 503):
                    # replica backpressure / draining / closed: the
                    # request never started — try the next replica
                    return "saturated"
                if resp.status in (400, 413):
                    # the REQUEST's fault; identical on every replica
                    self._forward_reject(client, resp.status, payload)
                    return "done"
                return "conn_error"  # 5xx: replica trouble
            self.metrics.requests.inc(label=str(r.index))
            with self._lock:
                r.requests_routed += 1
            if not stream:
                try:
                    payload = resp.read()
                except _replica_err:
                    # nothing reached the client yet — retryable
                    return "conn_error"
                self._forward_reject(client, 200, payload)
                return "done"
            return self._pipe_sse(r, resp, client, t_recv, asp)
        finally:
            conn.close()

    def _forward_reject(self, client, code, payload):
        try:
            obj = json.loads(payload or b"{}")
        except ValueError:
            obj = {"raw": payload.decode("utf-8", "replace")}
        if client.headers_sent:
            # the SSE stream is already open (prior attempt died after
            # the handshake) — a status line now would corrupt it
            client.error_event(dict(obj, reason=obj.get(
                "reason", f"http_{code}")))
            return
        self._send_json(client.h, code, obj)

    def _pipe_sse(self, r, resp, client, t_recv, asp=None):
        """Forward the replica's SSE stream event-block by event-block.
        Token events count toward the unstarted/started boundary; a
        replica failure after the first forwarded token ends the
        client stream with a terminal error event instead of a retry.
        """
        import http.client

        tid = None if asp is None else asp.trace_id
        tokens_forwarded = 0
        try:
            for block, event in _iter_sse_blocks(resp):
                if not client.write(block):
                    return "client_gone"
                if event == "token":
                    if tokens_forwarded == 0:
                        self.metrics.ttft.observe(
                            self.clock() - t_recv, trace_id=tid,
                        )
                    tokens_forwarded += 1
                elif event in ("done", "error"):
                    return "done"
            # stream ended without a terminal event: replica died
            raise OSError("replica stream ended mid-request")
        except (OSError, http.client.HTTPException):
            if tokens_forwarded == 0:
                # unstarted — safe to replay on another replica
                self.metrics.retries.inc(label="midstream_unstarted",
                                         trace_id=tid)
                return "midstream_unstarted"
            # counted before the client hears of it: a client that reads
            # the counter after its error event sees the abort
            self.metrics.stream_aborts.inc(label=ABORT_REPLICA_FAILED,
                                           trace_id=tid)
            client.error_event({
                "reason": ABORT_REPLICA_FAILED,
                "replica": r.index,
                "tokens_forwarded": tokens_forwarded,
            })
            return "failed_after_tokens"


class _ClientStream:
    """The router's half-open SSE response: headers sent lazily at the
    first forwarded block, so an unstarted request can still fail over
    to another replica (or shed with a plain HTTP status)."""

    def __init__(self, h, metrics, trace_id=None):
        self.h = h
        self.metrics = metrics
        self.trace_id = trace_id
        self.headers_sent = False
        self.client_gone = False

    def _send_headers(self):
        self.h.send_response(200)
        self.h.send_header("Content-Type", "text/event-stream")
        self.h.send_header("Cache-Control", "no-cache")
        self.h.send_header("Connection", "close")
        self.h.end_headers()
        self.headers_sent = True
        self.metrics.http_requests.inc(label="200")

    def write(self, block):
        """Forward one SSE event block; False when the client is gone
        (the caller aborts the upstream read)."""
        if self.client_gone:
            return False
        try:
            if not self.headers_sent:
                self._send_headers()
            self.h.wfile.write(block)
            self.h.wfile.flush()
            return True
        except OSError:
            self.client_gone = True
            self.metrics.stream_aborts.inc(
                label=ABORT_CLIENT_DISCONNECT, trace_id=self.trace_id,
            )
            return False

    def error_event(self, payload):
        if self.client_gone:
            return
        try:
            if not self.headers_sent:
                self._send_headers()
            data = json.dumps(payload)
            self.h.wfile.write(
                f"event: error\ndata: {data}\n\n".encode("utf-8")
            )
            self.h.wfile.flush()
        except OSError:
            self.client_gone = True


def _iter_sse_blocks(fp):
    """Yield ``(raw_block_bytes, event_name)`` per SSE event from a
    replica response — raw bytes so forwarding is byte-faithful, the
    event name so the router can track the token/terminal boundary.

    A tail without its blank-line terminator is a TRUNCATED block (the
    replica died mid-write) and is deliberately dropped — forwarding
    half a ``data:`` line would corrupt the client's stream right
    before the terminal error event; complete blocks always flush
    inside the loop because writers end every event with ``\\n\\n``."""
    lines = []
    event = None
    for raw in fp:
        line = raw.decode("utf-8", "replace").rstrip("\n").rstrip("\r")
        if line:
            lines.append(raw)
            if line.startswith("event:"):
                event = line[6:].strip()
            continue
        if lines:
            yield b"".join(lines) + b"\n", event
            lines, event = [], None
