"""Recompilation guard (the port of ``paddle_tpu/analysis/trace_guard.py``).

A fixed-shape program that is compiled again under drifting shapes
costs its build time while the card idles — the exact failure mode the
serving engines' shape buckets exist to prevent. In the port a
"compile" is a CUDA-graph capture of one of an engine's programs
(``serving/programs.py``), or a program's first, eager call on the CPU.
The guard watches them two ways:

- **explicit**: an engine's program inventory calls
  :meth:`TraceGuard.record_compile` with the JAX guard's key
  (``serving::prefill``, ...) and the program's signature at every
  capture;
- **polling**: :meth:`TraceGuard.watch` takes a zero-argument callable
  that returns a capture count (a ``Programs`` inventory's count of one
  key, where JAX polls ``jax.jit``'s ``_cache_size()``); :meth:`check`
  diffs it against the count at watch time.

When one key crosses ``max_compiles`` distinct signatures the guard
emits a ``recompile-storm`` Finding, forwards it to every subscribed
callback (the serving engine counts it in ``guard_fires``), counts it in
``paddle_analysis_guard_fires_total`` and notes it in the flight
recorder. JAX also turns it into a profiler lint event; the profiler
waits with ``ROADMAP.md`` queue A item 7, and so does
``find_leaked_tracers`` (a jax tracer escaping its trace has no torch
counterpart yet).
"""
from __future__ import annotations

import threading

from .findings import Finding, Severity

DEFAULT_MAX_COMPILES = 8


class TraceGuard:
    """Counts distinct compile signatures per function key."""

    def __init__(self, max_compiles=DEFAULT_MAX_COMPILES):
        self.max_compiles = int(max_compiles)
        self._sigs = {}      # key -> list of signatures, insertion order
        self._watched = {}   # name -> (jitted fn, last seen cache size)
        self._fired = set()  # keys that already produced a storm finding
        self.findings = []
        self._callbacks = []
        self._lock = threading.Lock()

    # ------------------------------------------------------------ explicit
    def record_compile(self, key, signature, origin=""):
        """Report a compile-cache MISS for ``key`` with ``signature``.
        Returns the storm Finding the miss triggered, else None."""
        with self._lock:
            sigs = self._sigs.setdefault(key, [])
            if signature in sigs:
                return None
            sigs.append(signature)
            n = len(sigs)
            if n <= self.max_compiles or key in self._fired:
                return None
            self._fired.add(key)
            recent = sigs[-3:]
        return self._fire(key, n, recent, origin)

    # ------------------------------------------------------------- polling
    def watch(self, name, counter):
        """Track a capture count: ``counter()`` returns how many times
        the program ``name`` was captured. The count at watch time is
        the baseline: only growth beyond it counts toward a storm."""
        with self._lock:
            self._watched[name] = [counter, self._cache_size(counter)]

    def unwatch(self, name):
        with self._lock:
            self._watched.pop(name, None)

    @staticmethod
    def _cache_size(counter):
        try:
            return int(counter())
        except Exception:
            return 0

    def check(self):
        """Poll watched counts; returns new storm findings. Growth
        is measured against the baseline count recorded by
        ``watch()``/``reset()`` — entries compiled before watching are
        not this guard's storms."""
        fired = []
        with self._lock:
            items = list(self._watched.items())
        for name, slot in items:
            size = self._cache_size(slot[0])
            with self._lock:
                grown = size - slot[1]  # slot[1]: baseline at watch/reset
                if grown <= self.max_compiles or name in self._fired:
                    continue
                self._fired.add(name)
            fired.append(self._fire(name, grown, [], "capture-poll"))
        return [f for f in fired if f is not None]

    # ------------------------------------------------------------- plumbing
    def on_fire(self, callback):
        """Subscribe ``callback(finding)`` to storm events."""
        self._callbacks.append(callback)
        return callback

    def _fire(self, key, n, recent, origin):
        detail = f"{key}:{n}"
        f = Finding(
            rule="recompile-storm", severity=Severity.WARNING,
            message=(
                f"{key!r} compiled {n} distinct signatures "
                f"(max {self.max_compiles}) — drifting shapes/dtypes; "
                f"bucket the inputs or mark them static"
                + (f"; recent: {recent}" if recent else "")
            ),
            graph=str(key), where=origin, detail=detail,
        )
        # under the lock: reset() clears this list under it, and an
        # unlocked append would race that clear (found by the repo's
        # own unlocked-shared-write pass)
        with self._lock:
            self.findings.append(f)
        # unified telemetry: storms are an alertable series, not only a
        # summary() line — publish into the process metrics registry
        try:
            from ..observability import get_registry

            get_registry().counter(
                "paddle_analysis_guard_fires_total",
                help="trace-guard findings (recompile storms), by rule "
                     "and watched graph",
            ).inc(rule=f.rule, graph=str(key))
            from ..observability import get_flight_recorder

            get_flight_recorder().note(
                "guard_fire", rule=f.rule, graph=str(key), detail=detail,
            )
        except Exception:
            pass
        for cb in list(self._callbacks):
            try:
                cb(f)
            except Exception:
                pass
        return f

    def compile_counts(self):
        with self._lock:
            counts = {k: len(v) for k, v in self._sigs.items()}
            for name, slot in self._watched.items():
                counts[name] = max(
                    counts.get(name, 0),
                    self._cache_size(slot[0]) - slot[1],
                )
        return counts

    def reset(self):
        with self._lock:
            self._sigs.clear()
            self._fired.clear()
            self.findings.clear()
            for slot in self._watched.values():
                slot[1] = self._cache_size(slot[0])  # re-baseline

