"""Flight recorder: a bounded ring of step records that survives crashes.

A training run that dies at step 80_000 with a NaN loss tells you
nothing unless someone was watching the dashboards at the time. The
flight recorder is the black box: every optimizer step appends a small
host-side record (timings, throughput, memory high-water, lazy loss
ref) to a ring buffer of the last K steps; trace-guard fires and other
notable events land in a second bounded ring. On a crash — an uncaught
exception, or the ``FLAGS_check_nan_inf`` sweep detecting a non-finite
op output — the recorder dumps one JSON bundle: the step ring, the
event ring, a full registry snapshot, and environment info. The bundle
is also available on demand (:meth:`FlightRecorder.dump`) and over the
``/flight`` HTTP endpoint.

Hook installation is explicit (:meth:`install`): it chains
``sys.excepthook`` (dump, then defer to the previous hook) and arms the
NaN hook slot, :data:`NANINF_HOOK`, so the bundle is written BEFORE the
RuntimeError propagates. ``watch()`` is the scoped variant
for drivers that own their try/except.

Lazy values (device-scalar losses held by gauges/records) are
materialized at dump time only; a dump is the one place a device sync
is acceptable — the process is dying anyway.

The PyTorch port's copy of ``paddle_tpu/observability/flight_recorder.py``.
JAX keeps the NaN hook's slot in its eager dispatcher
(``core/dispatch._NANINF_HOOK``), which the port does not have: the slot
lives here, ``install(nan_hook=True)`` arms it, and nothing fires it
until the ``check_nan_inf`` sweep (``amp/debugging.py``) is ported
(``ROADMAP.md`` queue A item 2). ``bundle(sync=True)`` reads CUDA values
(``.item()``); ``sync=False`` skips those whose event has not completed.
"""
from __future__ import annotations

import collections
import json
import os
import sys
import threading
import time
import traceback

from .registry import (
    _materialize,
    get_registry,
    nonblocking_active,
    nonblocking_values,
    value_is_ready,
)

DEFAULT_CAPACITY = 64

# the NaN hook's slot: ``[callable(op_name)]`` or ``[None]``; a check
# that finds a non-finite op output calls it before raising
NANINF_HOOK = [None]


def _jsonable(v):
    """Best-effort scalar materialization for bundle serialization:
    callables invoked, device/numpy scalars fetched (repr'd instead
    when still in flight under ``nonblocking_values``), else repr'd."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    try:
        if callable(v):
            v = v()
        # under nonblocking_values an in-flight device value is repr'd;
        # a normal dump blocks a moment and reports the number
        if nonblocking_active() and not value_is_ready(v):
            return repr(v)
        return _materialize(v)
    except Exception:
        return repr(v)


class FlightRecorder:
    """Bounded ring buffer of step records + crash-dumping hooks."""

    def __init__(self, capacity=DEFAULT_CAPACITY, registry=None,
                 dump_dir=None, event_capacity=256):
        self.capacity = int(capacity)
        self.registry = registry or get_registry()
        self.dump_dir = dump_dir or os.environ.get(
            "PADDLE_TPU_FLIGHT_DIR", "."
        )
        self._ring = collections.deque(maxlen=self.capacity)
        self._events = collections.deque(maxlen=int(event_capacity))
        self._lock = threading.Lock()
        self._installed = False
        self._prev_excepthook = None
        self._dump_count = 0
        self.last_dump_path = None
        # name -> zero-arg callable; each contributes one bundle section
        # (e.g. the SLO monitor's active alerts + recent window samples)
        self._sections = {}

    # ------------------------------------------------------------ feeding
    def record_step(self, record):
        """Append one step record (a small plain dict; values may be
        lazy — they materialize at dump time)."""
        with self._lock:
            self._ring.append(record)

    def note(self, kind, **info):
        """Append a notable event (guard fire, scale skip, restart...)."""
        ev = {"kind": str(kind), "time": time.time()}
        ev.update(info)
        with self._lock:
            self._events.append(ev)

    def steps(self):
        with self._lock:
            return list(self._ring)

    def events(self):
        with self._lock:
            return list(self._events)

    def add_section(self, name, fn):
        """Register a provider whose ``fn()`` output lands under
        ``bundle()['sections'][name]``. Replace-on-register, matching
        the metrics registry: the newest owner of a name wins (an
        engine reload re-attaching its monitor must not stack stale
        providers)."""
        with self._lock:
            self._sections[str(name)] = fn

    def remove_section(self, name):
        with self._lock:
            self._sections.pop(str(name), None)

    # ------------------------------------------------------------ dumping
    def bundle(self, reason="on_demand", exc=None, sync=True):
        """The diagnostic bundle as a plain dict (lazy values
        materialized here — the only place a device sync is allowed).

        ``sync=False`` is the NaN-hook mode: the dump runs while the
        step's work is still queued on the device, so fetching an
        in-flight device value (this very step's loss) would block —
        not-ready values are repr'd / skipped instead of fetched."""
        if not sync:
            with nonblocking_values():
                return self.bundle(reason=reason, exc=exc, sync=True)
        with self._lock:
            steps = [dict(r) for r in self._ring]
            events = [dict(e) for e in self._events]
            providers = list(self._sections.items())
        sections = {}
        for sec_name, fn in providers:
            # a broken provider must never take the crash dump with it
            try:
                sections[sec_name] = fn()
            except Exception as e:  # pragma: no cover - defensive
                sections[sec_name] = {"error": repr(e)}
        info = {"python": sys.version.split()[0]}
        try:
            import torch

            info["torch"] = torch.__version__
            info["devices"] = [
                f"cuda:{i}:{torch.cuda.get_device_name(i)}"
                for i in range(torch.cuda.device_count())
            ]
            info["process_index"] = 0
            info["process_count"] = 1
        except Exception:
            pass
        exc_info = None
        if exc is not None:
            exc_info = {
                "type": type(exc).__name__,
                "message": str(exc),
                "traceback": "".join(
                    traceback.format_exception(
                        type(exc), exc, exc.__traceback__
                    )
                ),
            }
        try:
            registry_snap = self.registry.snapshot()
        except Exception:
            registry_snap = {}
        # name the requests in flight: a NaN/watchdog bundle that says
        # WHICH traces were mid-decode turns "something was running"
        # into a /trace (or serve_bench --trace-out) lookup
        try:
            from .tracing import get_tracer

            tracer = get_tracer()
            traces_in_flight = tracer.active_trace_ids()
            spans_in_flight = tracer.active_spans()
        except Exception:
            traces_in_flight, spans_in_flight = [], []
        return _jsonable({
            "reason": reason,
            "time": time.time(),
            "capacity": self.capacity,
            "exception": exc_info,
            "steps": steps,
            "events": events,
            "traces_in_flight": traces_in_flight,
            "spans_in_flight": spans_in_flight,
            "sections": sections,
            "registry": registry_snap,
            "env": info,
        })

    def dump(self, path=None, reason="on_demand", exc=None, sync=True):
        """Write the bundle as JSON; returns the path written."""
        bundle = self.bundle(reason=reason, exc=exc, sync=sync)
        if path is None:
            with self._lock:
                self._dump_count += 1
                n = self._dump_count
            path = os.path.join(
                self.dump_dir,
                f"flight_{os.getpid()}_{n}.json",
            )
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(bundle, f, indent=1, default=str)
        self.last_dump_path = path
        return path

    # -------------------------------------------------------------- hooks
    def _on_nan(self, op_name):
        self.note("naninf", op=str(op_name))
        try:
            # sync=False: this hook runs while the step's work is still
            # queued — blocking on its own in-flight values would stall
            # the dump
            self.dump(reason=f"naninf:{op_name}", sync=False)
        except Exception:
            pass

    def _excepthook(self, etype, evalue, etb):
        try:
            if evalue is not None and evalue.__traceback__ is None:
                evalue = evalue.with_traceback(etb)
            self.dump(reason="uncaught_exception", exc=evalue)
        except Exception:
            pass
        prev = self._prev_excepthook or sys.__excepthook__
        prev(etype, evalue, etb)

    def install(self, nan_hook=True, excepthook=True):
        """Arm the crash hooks. Chained, not clobbered: the previous
        ``sys.excepthook`` still runs after the dump."""
        if self._installed:
            return self
        if excepthook:
            self._prev_excepthook = sys.excepthook
            sys.excepthook = self._excepthook
        if nan_hook:
            NANINF_HOOK[0] = self._on_nan
        self._installed = True
        return self

    def uninstall(self):
        if not self._installed:
            return
        if self._prev_excepthook is not None:
            sys.excepthook = self._prev_excepthook
            self._prev_excepthook = None
        # ``==``: each access of a bound method makes a new object, so
        # JAX's ``is`` test never clears its slot
        if NANINF_HOOK[0] == self._on_nan:
            NANINF_HOOK[0] = None
        self._installed = False

    def watch(self, reason="exception"):
        """Scoped crash capture::

            with recorder.watch():
                train()   # any exception dumps a bundle, then re-raises
        """
        recorder = self

        class _Watch:
            def __enter__(self):
                return recorder

            def __exit__(self, etype, evalue, etb):
                if etype is not None:
                    try:
                        recorder.dump(
                            reason=f"watch:{reason}", exc=evalue
                        )
                    except Exception:
                        pass
                return False

        return _Watch()

    def clear(self):
        with self._lock:
            self._ring.clear()
            self._events.clear()


# ------------------------------------------------------- process default
_DEFAULT = [None]
_DEFAULT_LOCK = threading.Lock()


def get_flight_recorder() -> FlightRecorder:
    with _DEFAULT_LOCK:
        if _DEFAULT[0] is None:
            _DEFAULT[0] = FlightRecorder(
                capacity=int(os.environ.get(
                    "PADDLE_TPU_FLIGHT_CAPACITY", DEFAULT_CAPACITY
                ))
            )
        return _DEFAULT[0]


def set_flight_recorder(recorder):
    with _DEFAULT_LOCK:
        prev, _DEFAULT[0] = _DEFAULT[0], recorder
    return prev
