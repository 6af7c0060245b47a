"""Deterministic fault-injection harness for serving and training (a copy
of ``paddle_tpu/chaos.py``, which is stdlib only).

Production failure modes (a torn checkpoint directory, a process killed
mid-weight-swap, a checkpoint writer thread that wedges) are
timing-dependent. This module makes them deterministic, so the tests can
drive the refusal, timeout and rollback paths directly:

- :class:`ChaosMonkey`, a scripted fault plan. Production seams call
  :func:`poke` with a site name; when a monkey is installed and a plan
  is armed for that site, the poke raises the armed exception (or runs a
  callback) on exactly the scheduled invocations. Value seams call
  :func:`poke_value`. With no monkey installed a poke is one
  module-attribute read.
- :class:`ChaosClock`, a manual-advance monotonic clock.
- :func:`tear_checkpoint`, the torn-directory shapes the commit and
  verify protocol must catch, its victim file picked deterministically.
- :func:`slow_serializer` / :func:`wedged_serializer`, which wrap a
  ``CheckpointManager``'s serialize seam so backpressure and drain
  timeouts run on demand.

Instrumented sites in the port: ``reload.prepare`` and ``reload.apply``
(the live weight swap, ``serving/reload.py`` and the engines' apply:
arming ``reload.apply`` is the deterministic "kill mid-swap");
``kv.send_frame`` and ``kv.recv_frame`` (the KV transfer wire,
``serving/fleet/kv_transfer.py``: a fault there is a socket drop
mid-exchange); ``train.step_begin`` (a blocking callback is the
deterministic wedged step) and ``train.loss`` (a value seam: a callback
returning ``float("nan")`` is the deterministic anomaly), both in
``jit/trainer.py``. ``serving.chaos`` re-exports this module verbatim.
"""
from __future__ import annotations

import contextlib
import os
import threading


class ChaosError(RuntimeError):
    """Default exception an armed fault raises at its site."""


class ChaosClock:
    """Manual-advance monotonic clock (drop-in for ``time.monotonic``).

    ``clock()`` returns the current value; ``advance(dt)`` moves it;
    ``sleep(dt)`` advances without blocking (hand it to code that
    sleeps so waits become deterministic)."""

    def __init__(self, start=1000.0):
        self._t = float(start)
        self._lock = threading.Lock()

    def __call__(self):
        with self._lock:
            return self._t

    def advance(self, dt):
        with self._lock:
            self._t += float(dt)
            return self._t

    # alias so the clock can stand in for time.sleep in injected code
    def sleep(self, dt):
        self.advance(dt)


class _Plan:
    __slots__ = ("after", "times", "exc", "callback")

    def __init__(self, after, times, exc, callback):
        self.after = int(after)
        self.times = times if times is None else int(times)
        self.exc = exc
        self.callback = callback


class ChaosMonkey:
    """A scripted set of faults keyed by site name.

    ``fail(site)`` arms an exception; ``on(site, fn)`` arms a callback
    (``fn(**ctx)`` — raise from it to fault, return to observe; at a
    :func:`poke_value` site the callback receives ``value=`` and a
    non-None return REPLACES the value). ``after=N`` skips the first N
    pokes; ``times=K`` fires on the next K pokes then disarms
    (``times=None`` = every poke). ``fired(site)`` counts actual
    fires, ``poked(site)`` all pokes — tests assert on these instead
    of sleeping and hoping."""

    def __init__(self):
        self._plans = {}
        self._pokes = {}
        self._fires = {}
        self._lock = threading.Lock()

    def fail(self, site, *, times=1, after=0, exc=None):
        self._plans[site] = _Plan(
            after, times, exc or ChaosError(f"chaos: {site}"), None
        )
        return self

    def on(self, site, callback, *, times=None, after=0):
        self._plans[site] = _Plan(after, times, None, callback)
        return self

    def disarm(self, site):
        self._plans.pop(site, None)

    def poked(self, site):
        return self._pokes.get(site, 0)

    def fired(self, site):
        return self._fires.get(site, 0)

    def _schedule(self, site):
        """One poke's bookkeeping; returns the armed (exc, callback)
        when this poke fires, else (None, None)."""
        with self._lock:
            self._pokes[site] = self._pokes.get(site, 0) + 1
            plan = self._plans.get(site)
            if plan is None:
                return None, None
            if plan.after > 0:
                plan.after -= 1
                return None, None
            if plan.times is not None:
                if plan.times <= 0:
                    return None, None
                plan.times -= 1
            self._fires[site] = self._fires.get(site, 0) + 1
            return plan.exc, plan.callback

    def poke(self, site, **ctx):
        exc, callback = self._schedule(site)
        if callback is not None:
            callback(**ctx)
        elif exc is not None:
            raise exc

    def poke_value(self, site, value, **ctx):
        """Value seam: an armed callback gets ``value=`` and may return
        a replacement (None = observe only); an armed exception raises
        as usual. Unarmed pokes return ``value`` untouched."""
        exc, callback = self._schedule(site)
        if callback is not None:
            out = callback(value=value, **ctx)
            return value if out is None else out
        if exc is not None:
            raise exc
        return value


# one optional process-wide monkey; poke() is a no-op attribute read
# when none is installed, so the production seams cost nothing
_ACTIVE = None


def install(monkey):
    global _ACTIVE
    _ACTIVE = monkey
    return monkey


def uninstall():
    global _ACTIVE
    _ACTIVE = None


def active():
    return _ACTIVE


def poke(site, **ctx):
    """Production seam: fault here when a monkey armed this site."""
    m = _ACTIVE
    if m is not None:
        m.poke(site, **ctx)


def poke_value(site, value, **ctx):
    """Production VALUE seam: an armed monkey may observe or replace
    ``value`` (see :meth:`ChaosMonkey.poke_value`); with no monkey the
    value passes through untouched."""
    m = _ACTIVE
    if m is None:
        return value
    return m.poke_value(site, value, **ctx)


@contextlib.contextmanager
def chaos(monkey=None):
    """``with chaos() as monkey: monkey.fail("reload.apply"); ...`` —
    installs (a fresh) monkey for the block, always uninstalls."""
    m = monkey or ChaosMonkey()
    prev = _ACTIVE
    install(m)
    try:
        yield m
    finally:
        install(prev) if prev is not None else uninstall()


# ------------------------------------------------- checkpoint corruption
def tear_checkpoint(step_dir, mode="truncate_shard"):
    """Deterministically damage a committed checkpoint directory the way
    real crashes/bit-rot do. Returns the damaged file's path (or the
    removed one). Modes: ``truncate_shard`` (torn write),
    ``bitflip_shard`` (silent corruption), ``delete_shard`` (lost
    file), ``delete_manifest`` (commit marker gone). The victim shard
    is the first ``.npy`` in sorted order — deterministic, so a test's
    failure reproduces."""
    if mode == "delete_manifest":
        p = os.path.join(step_dir, "manifest.json")
        os.remove(p)
        return p
    shards = sorted(
        f for f in os.listdir(step_dir) if f.endswith(".npy")
    )
    if not shards:
        raise ValueError(f"no shard files under {step_dir}")
    p = os.path.join(step_dir, shards[0])
    if mode == "delete_shard":
        os.remove(p)
    elif mode == "truncate_shard":
        size = os.path.getsize(p)
        with open(p, "r+b") as f:
            f.truncate(max(size // 2, 1))
    elif mode == "bitflip_shard":
        with open(p, "r+b") as f:
            f.seek(-1, os.SEEK_END)
            last = f.read(1)
            f.seek(-1, os.SEEK_END)
            f.write(bytes([last[0] ^ 0xFF]))
    else:
        raise ValueError(f"unknown tear mode {mode!r}")
    return p


# --------------------------------------------------- writer-thread faults
def slow_serializer(manager, seconds, sleep=None):
    """Wrap ``manager``'s serialize seam with a fixed delay — drives the
    async-saver backpressure path. Returns an ``undo()`` callable."""
    import time as _time

    sleep = sleep or _time.sleep
    inner = manager._serialize

    def slowed(state, path):
        sleep(float(seconds))
        return inner(state, path)

    manager._serialize = slowed
    return lambda: setattr(manager, "_serialize", inner)


def wedged_serializer(manager, release):
    """Wrap the serialize seam so the writer BLOCKS until ``release``
    (a ``threading.Event``) is set — the wedged-writer scenario behind
    emergency-save grace timeouts. Returns an ``undo()`` callable."""
    inner = manager._serialize

    def wedged(state, path):
        release.wait()
        return inner(state, path)

    manager._serialize = wedged
    return lambda: setattr(manager, "_serialize", inner)
