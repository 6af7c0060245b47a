"""Sessions: the conversation as the serving unit (counterpart of
``paddle_tpu/serving/sessions.py``).

A chat product sends one engine a longer prompt every turn: turn N+1's
prompt is turn N's prompt, turn N's answer and the new user message.
The KV of everything before the new message exists once turn N ends:
the prefix cache holds it (decode-publish, ``paged_engine.py``). What
this module adds is the bookkeeping that makes conversations
first-class:

- :class:`SessionStore` maps a client's ``session_id`` to its token
  chain and turn count: ``touch`` at submit (create or refresh),
  ``note_turn`` at finish (the whole conversation's ids so far, the
  prefix the next turn warm-hits);
- **retirement** is TTL and LRU: a session idle past ``ttl_s``, or the
  oldest idle one past ``max_sessions``, leaves the store (counted by
  reason). Retirement is bookkeeping only: the pages live and die by the
  prefix cache's references and the spill tier's budgets, and a retired
  session that comes back warm-hits whatever of its prefix survives.

Sessions never change a token stream: matching is by token content
through the prefix cache, and a request without a ``session_id`` is
served as before. The clock is injectable; the store is driven from
the engine's loop only. The counters register in the process registry
(or ``registry=``) under JAX's names, and the store notes JAX's
flight-recorder events (``session_open``, ``session_retired``) in the
process recorder (or ``recorder=``).
"""
from __future__ import annotations

import time
from collections import OrderedDict

from ..observability import get_flight_recorder, get_registry
from .metrics import Counter, Gauge


class Session:
    """One conversation's bookkeeping: its id, the token ids of the whole
    conversation so far (prompt and answer of every finished turn), and
    its lifecycle times."""

    __slots__ = ("session_id", "tokens", "turns", "created",
                 "last_active")

    def __init__(self, session_id, now):
        self.session_id = str(session_id)
        self.tokens = ()      # the conversation's ids after its last turn
        self.turns = 0
        self.created = now
        self.last_active = now

    def __repr__(self):
        return (f"Session({self.session_id!r}, turns={self.turns}, "
                f"tokens={len(self.tokens)})")


class SessionStore:
    """Bounded TTL and LRU map of live conversations.

    ``max_sessions`` caps residency (the oldest idle retires first);
    ``ttl_s=None`` turns idle expiry off. All counters/gauges register
    under the serving namespace with replace-on-register, like every
    per-engine instrument."""

    def __init__(self, *, max_sessions=1024, ttl_s=None,
                 clock=time.monotonic, registry=None,
                 namespace="paddle_serving", recorder=None):
        self.max_sessions = int(max_sessions)
        if self.max_sessions < 1:
            raise ValueError("max_sessions must be >= 1")
        self.ttl_s = None if ttl_s is None else float(ttl_s)
        self.clock = clock
        self._sessions = OrderedDict()  # session_id -> Session, LRU
        self._rec = recorder if recorder is not None \
            else get_flight_recorder()
        ns = namespace
        self.active = Gauge(
            "sessions_active", prom_name=f"{ns}_sessions_active",
            help="conversations resident in the session store")
        self.created = Counter(
            "sessions_created",
            prom_name=f"{ns}_sessions_created_total",
            help="new sessions admitted")
        self.retired = Counter(
            "sessions_retired", labelname="reason",
            prom_name=f"{ns}_sessions_retired_total",
            help="sessions retired from the store, by reason "
                 "(ttl | lru)")
        self.turns = Counter(
            "session_turns", prom_name=f"{ns}_session_turns_total",
            help="finished turns recorded against a session")
        (registry or get_registry()).register_all([
            self.active, self.created, self.retired, self.turns,
        ])
        self.active.set(0.0)

    def __len__(self):
        return len(self._sessions)

    def get(self, session_id):
        return self._sessions.get(str(session_id))

    # ---------------------------------------------------------- lifecycle
    def touch(self, session_id):
        """Create or refresh at submit: sweeps the TTL, moves the session
        to the LRU end, retires sessions over the cap. Returns the live
        Session."""
        now = self.clock()
        self.sweep(now)
        sid = str(session_id)
        s = self._sessions.get(sid)
        if s is None:
            s = Session(sid, now)
            self._sessions[sid] = s
            self.created.inc()
            self._rec.note("session_open", session_id=sid)
            while len(self._sessions) > self.max_sessions:
                _, old = self._sessions.popitem(last=False)
                self._retire(old, "lru")
        else:
            self._sessions.move_to_end(sid)
        s.last_active = now
        self.active.set(float(len(self._sessions)))
        return s

    def note_turn(self, session_id, output_ids):
        """Record one finished turn: ``output_ids`` is the whole
        conversation so far (prompt and answer), the chain the prefix
        cache published and turn N+1 extends. None for an unknown
        session."""
        s = self._sessions.get(str(session_id))
        if s is None:
            return None
        s.tokens = tuple(int(t) for t in output_ids)
        s.turns += 1
        s.last_active = self.clock()
        self._sessions.move_to_end(s.session_id)
        self.turns.inc()
        return s

    def _retire(self, session, reason):
        self.retired.inc(label=reason)
        self._rec.note("session_retired",
                       session_id=session.session_id, reason=reason,
                       turns=session.turns)

    def sweep(self, now=None):
        """Retire every session idle past the TTL; returns how many."""
        if self.ttl_s is None:
            return 0
        if now is None:
            now = self.clock()
        dead = [sid for sid, s in self._sessions.items()
                if now - s.last_active > self.ttl_s]
        for sid in dead:
            self._retire(self._sessions.pop(sid), "ttl")
        if dead:
            self.active.set(float(len(self._sessions)))
        return len(dead)

    def close(self):
        self._sessions.clear()
        self.active.set(0.0)

    # -------------------------------------------------------- accounting
    def stats(self):
        return {
            "active": len(self._sessions),
            "max_sessions": self.max_sessions,
            "ttl_s": self.ttl_s,
            "created": int(self.created.value),
            "retired": self.retired.by_label(),
            "turns": int(self.turns.value),
        }
