"""Request scheduling for the serving engine.

FIFO + priority admission over a bounded queue with explicit
backpressure: ``submit`` never blocks — a full queue or an infeasible
request is rejected immediately with a machine-readable reason, which
is what a front-end needs to shed load instead of letting latency run
away. Deadlines are absolute (clock-relative at submit): a request that
expires while queued is failed without ever touching the accelerator;
the engine also sweeps running requests each step so an expired
sequence frees its slot mid-decode (partial tokens are kept).

The scheduler is deliberately clock-injectable (``clock=``) so timeout
behavior is deterministically testable on CPU.

A pure-Python copy of ``paddle_tpu/serving/scheduler.py`` (the port
imports nothing from the JAX package).
"""
from __future__ import annotations

import heapq
import itertools
import time

# the SLO traffic class a request carries when the caller names none
from ..observability.slo import DEFAULT_CLASS  # noqa: F401

# rejection / completion reasons (machine-readable, stable strings)
REASON_QUEUE_FULL = "queue_full"
REASON_TOO_LONG = "too_long"
REASON_SHAPE_MISMATCH = "shape_mismatch"
REASON_TIMEOUT = "timeout"
REASON_ENGINE_CLOSED = "engine_closed"
# demand-grown paged decode: a mid-decode page claim that neither the
# freelist nor prefix-cache eviction could satisfy sheds the request
# with this reason (partial tokens kept, terminal event fired) — an
# overcommitted arena degrades one request, never crashes the engine
REASON_PAGES_EXHAUSTED = "pages_exhausted"

# request lifecycle states
QUEUED = "QUEUED"
RUNNING = "RUNNING"
DONE = "DONE"
REJECTED = "REJECTED"
TIMEOUT = "TIMEOUT"
CANCELLED = "CANCELLED"


class RejectedError(RuntimeError):
    """Raised by ``submit`` on backpressure; ``.reason`` is one of the
    REASON_* constants."""

    def __init__(self, reason, detail=""):
        super().__init__(f"request rejected ({reason}): {detail}")
        self.reason = reason


class Request:
    """One decode request: a prompt plus its generation budget."""

    _ids = itertools.count()

    def __init__(self, input_ids, max_new_tokens, *, eos_token_id=None,
                 priority=0, deadline_s=None, slo_class=None,
                 session_id=None):
        import numpy as np

        ids = np.asarray(input_ids)
        if ids.ndim == 2:
            if ids.shape[0] != 1:
                raise ValueError(
                    "a Request is ONE sequence; got batch "
                    f"{ids.shape[0]} (submit one Request per row)"
                )
            ids = ids[0]
        self.input_ids = ids.astype(np.int32)
        self.prompt_len = int(ids.shape[-1])
        if self.prompt_len < 1:
            raise ValueError("a Request needs at least one prompt token")
        self.max_new_tokens = int(max_new_tokens)
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        self.eos_token_id = eos_token_id
        self.priority = int(priority)
        self.deadline_s = deadline_s  # relative seconds; resolved at submit
        # SLO traffic class (observability.slo): labels the latency
        # histograms and the trace root. The scheduler itself is
        # class-blind today — budget-aware admission is the follow-up.
        if slo_class is None:
            slo_class = DEFAULT_CLASS
        self.slo_class = str(slo_class)
        # conversation identity (serving.sessions): labels this request
        # as one turn of a chat session — session bookkeeping, router
        # affinity, and decode-publish chain continuity key on it. None
        # = a standalone request, served exactly as before.
        self.session_id = None if session_id is None else str(session_id)
        self.request_id = next(Request._ids)

    @property
    def total_tokens(self):
        return self.prompt_len + self.max_new_tokens


class RequestHandle:
    """The caller's view of a submitted request: status, tokens, and
    per-request timing, filled in as the engine progresses.

    Streaming surface: ``on_token(tok, handle)`` fires per emitted
    token, ``on_event(handle)`` fires EXACTLY ONCE when the handle
    reaches a terminal state (DONE/REJECTED/TIMEOUT/CANCELLED) — from
    wherever the transition happens: decode, submit-time reject, lazy
    queue expiry, or ``engine.close()``. That single-fire guarantee is
    what lets an SSE stream end with a terminal event instead of a
    silent hang when its request is shed. Callback exceptions are
    swallowed (a broken consumer must never wedge the engine loop)."""

    def __init__(self, request, on_token=None, on_event=None):
        self.request = request
        self.status = QUEUED
        self.reason = None          # set for REJECTED / TIMEOUT
        self.tokens = []            # emitted token ids (ints)
        self.submit_time = None
        self.admit_time = None      # wall time of admission (prefill)
        self.finish_time = None
        self.first_token_time = None
        self.admitted_step = None   # engine step index at admission
        self.finished_step = None
        self.weights_version = None  # engine weights at admission
        # distributed-tracing context (an observability.tracing.Span or
        # None): set by the front-end right after submit, read by the
        # engine at admission. None = sampled out — every engine
        # instrumentation site then allocates nothing.
        self.trace = None
        self._decode_span = None  # the engine's open per-request span
        self.on_token = on_token
        self.on_event = on_event
        self._terminal_fired = False

    @property
    def finished(self):
        return self.status in (DONE, REJECTED, TIMEOUT, CANCELLED)

    def _fire_token(self, tok):
        if self.on_token is not None:
            try:
                self.on_token(int(tok), self)
            except Exception:
                pass

    def _fire_terminal(self):
        """Notify the terminal transition exactly once (idempotent —
        every status-setting site calls this defensively)."""
        if self._terminal_fired:
            return
        self._terminal_fired = True
        if self.on_event is not None:
            try:
                self.on_event(self)
            except Exception:
                pass

    @property
    def output_ids(self):
        """prompt + generated tokens as one int32 numpy array."""
        import numpy as np

        return np.concatenate(
            [self.request.input_ids,
             np.asarray(self.tokens, np.int32)]
        ).astype(np.int32)

    @property
    def ttft(self):
        if self.first_token_time is None or self.submit_time is None:
            return None
        return self.first_token_time - self.submit_time

    def __repr__(self):
        return (
            f"RequestHandle(id={self.request.request_id}, "
            f"status={self.status}, tokens={len(self.tokens)})"
        )


class Scheduler:
    """Bounded priority+FIFO admission queue.

    Pop order: highest ``priority`` first, FIFO within a priority
    (heap key ``(-priority, seq)``). ``pop_next`` enforces the caller's
    token budget WITHOUT skipping past the head — strict ordering means
    a big request is delayed, never starved. Expired-deadline requests
    are failed lazily at pop time (and via ``sweep_expired``)."""

    def __init__(self, max_queue_size=64, clock=time.monotonic):
        self.max_queue_size = int(max_queue_size)
        self.clock = clock
        self._heap = []  # (-priority, seq, handle)
        self._seq = itertools.count()
        # handles that expired while queued, awaiting a metrics drain
        # (drain_timed_out empties it — bounded by queue size per step)
        self._timed_out = []

    @property
    def depth(self):
        return len(self._heap)

    def submit(self, request, on_token=None, on_event=None):
        """Enqueue; returns a RequestHandle. Raises RejectedError when
        the queue is full (bounded-queue backpressure). Callbacks are
        attached BEFORE the bound check so a queue-full reject still
        fires the terminal event (no silent SSE hang)."""
        handle = RequestHandle(request, on_token=on_token,
                               on_event=on_event)
        handle.submit_time = self.clock()
        if len(self._heap) >= self.max_queue_size:
            handle.status = REJECTED
            handle.reason = REASON_QUEUE_FULL
            handle.finish_time = handle.submit_time
            handle._fire_terminal()
            err = RejectedError(
                REASON_QUEUE_FULL,
                f"queue holds {len(self._heap)}/{self.max_queue_size}",
            )
            err.handle = handle  # engines return this instead of raising
            raise err
        heapq.heappush(
            self._heap, (-request.priority, next(self._seq), handle)
        )
        return handle

    def _expire(self, handle, now):
        handle.status = TIMEOUT
        handle.reason = REASON_TIMEOUT
        handle.finish_time = now
        handle._fire_terminal()
        self._timed_out.append(handle)

    def drain_timed_out(self):
        """Return-and-clear every handle that expired while queued since
        the last drain (sweep_expired AND pop_next both expire lazily;
        this is the single channel engines count timeouts from — and the
        clear keeps a long-running server from accumulating handles)."""
        out, self._timed_out = self._timed_out, []
        return out

    def deadline_of(self, handle):
        d = handle.request.deadline_s
        return None if d is None else handle.submit_time + d

    def sweep_expired(self):
        """Fail every queued request whose deadline has passed; returns
        the expired handles (callers feed them to metrics)."""
        now = self.clock()
        keep, expired = [], []
        for item in self._heap:
            h = item[2]
            dl = self.deadline_of(h)
            if dl is not None and now > dl:
                self._expire(h, now)
                expired.append(h)
            else:
                keep.append(item)
        if expired:
            self._heap = keep
            heapq.heapify(self._heap)
        return expired

    def pop_next(self, token_budget=None, fits=None):
        """The next admissible request, or None. Strict priority-FIFO:
        if the head does not fit ``token_budget`` (sum of prompt +
        max_new tokens the engine may still take in flight), nothing is
        admitted this call. ``fits`` is an optional per-request
        feasibility predicate with the same no-skip discipline (the
        prefix-caching engine's page-need check, which depends on cache
        state a scalar budget cannot express) — a head failing it is
        delayed, never overtaken. Expired heads are failed and
        skipped."""
        while self._heap:
            neg_pri, seq, handle = self._heap[0]
            dl = self.deadline_of(handle)
            now = self.clock()
            if dl is not None and now > dl:
                heapq.heappop(self._heap)
                self._expire(handle, now)
                continue
            if (
                token_budget is not None
                and handle.request.total_tokens > token_budget
            ):
                return None
            if fits is not None and not fits(handle.request):
                return None
            heapq.heappop(self._heap)
            return handle
        return None
