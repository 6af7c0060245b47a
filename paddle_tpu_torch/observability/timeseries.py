"""Bounded in-process time series over cumulative metrics.

The metrics registry is deliberately point-in-time: counters and
histogram bucket counts only ever grow, and a scrape sees one instant.
Burn-rate alerting and attainment dashboards need the other axis —
"what happened over the last minute" — without an external Prometheus.
:class:`TimeSeriesRing` is that axis: a fixed-capacity ring of
``(t, {key: float})`` samples appended on a background interval, with
windowed delta/rate readers that tolerate counter resets (an engine
reload re-registers fresh metrics, so a cumulative series can step
DOWN; a reset-naive ``last - first`` would go negative and a dashboard
would show a physically impossible rate).

Memory is bounded by construction: ``capacity`` samples, each a flat
dict of floats. No wall-clock calls happen inside the ring — the caller
supplies every timestamp — so tests drive it with a fake clock exactly
like ``autotune``'s timer discipline.
"""

from __future__ import annotations

import threading


class TimeSeriesRing:
    """Fixed-capacity ring of ``(t, values)`` samples with windowed
    readers.

    ``values`` is a flat ``{key: float}`` dict; keys may come and go
    between samples (a class with no traffic yet simply has no series).
    All readers take an explicit ``now`` (default: the latest sample's
    timestamp) so the ring itself never consults a clock."""

    def __init__(self, capacity=512):
        if int(capacity) < 2:
            raise ValueError("TimeSeriesRing needs capacity >= 2")
        self.capacity = int(capacity)
        self._buf = [None] * self.capacity
        self._head = 0  # next write slot
        self._len = 0
        self._lock = threading.Lock()

    def __len__(self):
        with self._lock:
            return self._len

    def append(self, t, values):
        """Record one sample. ``values`` is copied (floats coerced) so
        the caller may reuse its dict."""
        snap = {str(k): float(v) for k, v in values.items()}
        with self._lock:
            self._buf[self._head] = (float(t), snap)
            self._head = (self._head + 1) % self.capacity
            self._len = min(self._len + 1, self.capacity)

    def _ordered(self):
        # oldest -> newest; caller must hold the lock
        if self._len < self.capacity:
            return self._buf[: self._len]
        return self._buf[self._head:] + self._buf[: self._head]

    def last(self, k=1):
        """The most recent ``k`` samples, oldest first, as
        ``[(t, values)]`` copies."""
        with self._lock:
            tail = self._ordered()[-int(k):]
            return [(t, dict(v)) for t, v in tail]

    def window(self, window_s=None, now=None):
        """Samples inside ``[now - window_s, now]`` plus ONE sample just
        before the window start when available — the baseline that makes
        a windowed delta cover the full span instead of starting at the
        first in-window sample."""
        with self._lock:
            ordered = [(t, dict(v)) for t, v in self._ordered()]
        if not ordered:
            return []
        if now is None:
            now = ordered[-1][0]
        if window_s is None:
            return [s for s in ordered if s[0] <= now]
        lo = float(now) - float(window_s)
        out, baseline = [], None
        for s in ordered:
            if s[0] > now:
                continue
            if s[0] < lo:
                baseline = s
            else:
                out.append(s)
        if baseline is not None:
            out.insert(0, baseline)
        return out

    def series(self, key, window_s=None, now=None):
        """``[(t, value)]`` for one key over the window, skipping
        samples where the key is absent."""
        key = str(key)
        return [
            (t, v[key]) for t, v in self.window(window_s, now) if key in v
        ]

    def delta(self, key, window_s=None, now=None):
        """Counter-reset-tolerant increase of a cumulative series over
        the window: the sum of POSITIVE step-wise deltas. A step down
        (engine reload re-registering the metric at zero) contributes
        nothing instead of a negative spike. 0.0 with < 2 points."""
        pts = self.series(key, window_s, now)
        if len(pts) < 2:
            return 0.0
        total = 0.0
        for (_, a), (_, b) in zip(pts, pts[1:]):
            if b > a:
                total += b - a
        return total

    def rate(self, key, window_s=None, now=None):
        """``delta / elapsed`` per second over the window's actual span
        (first to last in-window point, not the nominal window — the
        ring may hold less history than asked for). 0.0 with < 2 points
        or zero span."""
        pts = self.series(key, window_s, now)
        if len(pts) < 2:
            return 0.0
        span = pts[-1][0] - pts[0][0]
        if span <= 0:
            return 0.0
        return self.delta(key, window_s, now) / span

    def latest(self, key, default=None):
        """Most recent value of ``key`` (gauge read), or ``default``."""
        key = str(key)
        with self._lock:
            ordered = self._ordered()
            for t, v in reversed(ordered):
                if key in v:
                    return v[key]
        return default
