"""Resilient training runtime: anomaly sentinel, watchdog, replay loop
(the port of ``paddle_tpu/training/resilience.py``).

A multi-hour training job should SURVIVE bad steps, wedged collectives,
and dead workers — the reference's Fleet stack treats them as seconds
of rollback, not a lost run. This module is the training-side twin of
the serving tier's zero-downtime ops, built on the same
discipline: every failure mode has a deterministic chaos seam, every
response is counted, and nothing here ever adds a device sync to the
hot loop.

Three layers:

- :class:`AnomalySentinel` — attached to a
  ``jit.trainer.CompiledTrainStep`` (``trainer.attach_sentinel``) or
  ``Model.fit(sentinel=)`` (hapi, ``ROADMAP.md`` queue A item 5, is
  not ported). Each step's loss rides along as a DEVICE REF (a
  ``DeviceValue``: the loss and a CUDA event recorded after the step);
  the sentinel only inspects refs whose ``is_ready()`` reports done
  (``observability.registry.value_is_ready``, an event query), so
  detection never blocks dispatch. On a NaN/inf loss or a configurable
  loss-spike it walks a policy ladder:

  * **skip-step** — restore the one pre-step on-device snapshot the
    sentinel keeps (params, buffers, every optimizer accumulator, the
    step count and the scaler's state; a device copy per tensor,
    enqueued on the step's stream before the in-place update, no host
    sync), drop the offending batch, and keep going. The RNG stream deliberately
    keeps advancing — step k+1 uses the key it would have used anyway,
    so a skipped batch never reshuffles every later key.
  * **rollback** — drain the checkpoint writer, restore the last
    COMMITTED checkpoint via ``CheckpointManager.restore_or_init``
    (params, optimizer moments, the LR schedule, step count, and
    registered extra state),
    then raise :class:`RollbackAndReplay` so the driving loop rewinds
    its DATA CURSOR and replays the same batches: the recovered
    trajectory exactly equals an uninterrupted run.
  * **abort** — dump a flight-recorder bundle (nonblocking
    materialization: the bundle never deadlocks on the dying step's
    own in-flight refs) and raise :class:`TrainingAborted`.

  Every response is counted in
  ``paddle_training_anomaly_total{kind,action}`` and recorded as a
  flight-ring event.

- :class:`TrainWatchdog` — a monitor thread (injectable clock) that
  fires when the dispatch-to-dispatch gap exceeds ``stall_seconds``,
  EXCLUDING checkpoint-blocked time (it listens on the StepMeter's
  ``note_blocked`` seam, so an emergency save is never misread as a
  hang), plus per-rank heartbeat files (mtime = last dispatch) so a
  straggling or wedged PEER rank fires too. A fire bumps
  ``paddle_training_watchdog_fires_total{kind}``, attributes the
  coming run break (``StepMeter.note_wedged``), and dumps a flight
  bundle BEFORE the job dies silently.

- :func:`run_resilient` — the replay-capable training loop: the step
  index is the data cursor, ``batch_fn(step)`` must be deterministic
  per index (the usual seeded-pipeline contract), and
  :class:`RollbackAndReplay` rewinds it.

Chaos seams (``paddle_tpu_torch.chaos``): ``train.loss`` (value seam —
a callback returning ``float("nan")`` is the deterministic anomaly) and
``train.step_begin`` (a blocking callback is the deterministic wedged
step). The elastic supervisor that relaunches a dead rank waits with the
distributed port (``ROADMAP.md`` queue A item 6).
"""
from __future__ import annotations

import os
import statistics
import threading
import time

import numpy as np

from ..observability import Counter, get_registry
from ..observability.registry import value_is_ready

KIND_NANINF = "naninf"
KIND_LOSS_SPIKE = "loss_spike"

ACTION_SKIP = "skip"
ACTION_ROLLBACK = "rollback"
ACTION_ABORT = "abort"


class RollbackAndReplay(RuntimeError):
    """Control-flow: the sentinel restored the last committed
    checkpoint; the driving loop must rewind its data cursor to
    ``action.resume_step`` and replay. :func:`run_resilient` handles
    it; custom loops must too (or run with a policy that never rolls
    back)."""

    def __init__(self, action):
        self.action = action
        super().__init__(
            f"anomaly ({action.kind}) at step {action.step}: rolled "
            f"back, replay from step {action.resume_step}"
        )


class TrainingAborted(RuntimeError):
    """The policy ladder's last rung: the anomaly was not recoverable
    (or recovery budget exhausted); a flight bundle was dumped."""

    def __init__(self, action, bundle_path=None):
        self.action = action
        self.bundle_path = bundle_path
        super().__init__(
            f"training aborted: {action.kind} at step {action.step}"
            + (f" (flight bundle: {bundle_path})" if bundle_path else "")
        )


class Action:
    """One sentinel response."""

    __slots__ = ("kind", "action", "step", "value", "resume_step",
                 "dropped_steps")

    def __init__(self, kind, action, step, value=None, resume_step=None,
                 dropped_steps=0):
        self.kind = kind
        self.action = action
        self.step = int(step)
        self.value = value
        self.resume_step = resume_step
        self.dropped_steps = int(dropped_steps)

    def __repr__(self):
        return (f"Action({self.kind}, {self.action}, step={self.step}, "
                f"resume_step={self.resume_step})")


class SentinelPolicy:
    """What counts as an anomaly, and what to do about it.

    ``nan_action`` / ``spike_action`` pick the ladder entry point per
    kind (``"skip" | "rollback" | "abort"``); the ladder always
    escalates downward when a rung is unavailable (no snapshot → no
    skip; no manager or no committed checkpoint → no rollback) or its
    budget (``max_skips`` / ``max_rollbacks``, per run) is spent.

    Spike detection: a loss is a spike when a window of
    ``spike_window`` healthy losses has at least ``min_history``
    entries and the new loss exceeds ``spike_factor`` x the window
    median (scale-free), or exceeds the absolute ``loss_ceiling`` when
    one is set. NaN/inf is always ``naninf`` regardless of history.

    Cost note: choosing ``"skip"`` for EITHER kind turns on the
    sentinel's pre-step on-device snapshot — a full copy of params +
    optimizer state + buffers refreshed every step. That is the price
    of undoing one step in place; at 7B scale it roughly doubles the
    optimizer-state footprint, which is why both actions default to
    rollback (no snapshot, no extra HBM) and skip is opt-in.
    """

    def __init__(self, nan_action=ACTION_ROLLBACK,
                 spike_action=ACTION_ROLLBACK, *, spike_window=32,
                 spike_factor=10.0, min_history=4, loss_ceiling=None,
                 max_skips=3, max_rollbacks=2):
        for a in (nan_action, spike_action):
            if a not in (ACTION_SKIP, ACTION_ROLLBACK, ACTION_ABORT):
                raise ValueError(f"unknown sentinel action {a!r}")
        self.nan_action = nan_action
        self.spike_action = spike_action
        self.spike_window = int(spike_window)
        self.spike_factor = float(spike_factor)
        self.min_history = int(min_history)
        self.loss_ceiling = (
            float(loss_ceiling) if loss_ceiling is not None else None
        )
        self.max_skips = int(max_skips)
        self.max_rollbacks = int(max_rollbacks)

    def action_for(self, kind):
        return self.nan_action if kind == KIND_NANINF \
            else self.spike_action

    def skip_enabled(self):
        return ACTION_SKIP in (self.nan_action, self.spike_action)


class AnomalySentinel:
    """Watch per-step losses; respond by the policy ladder.

    Wiring: ``trainer.attach_sentinel(sentinel)`` (the trainer calls
    :meth:`before_step` / :meth:`after_step` around each optimizer
    step). ``manager`` is the
    ``checkpoint.CheckpointManager`` the rollback rung restores from —
    without one, rollback escalates to abort.

    ``sync=True`` blocks on each step's loss ref before the next step
    dispatches — detection latency becomes exactly zero at the cost of
    per-step device sync. The default (``sync=False``) checks only
    READY refs: on real accelerators detection lags dispatch by the
    in-flight window, so a skip may drop the couple of steps that
    dispatched behind the bad one (counted in
    ``Action.dropped_steps``); a rollback first QUARANTINES any
    generation committed at/after the anomalous step (the detection
    lag can let one land), so the restore always predates the anomaly.
    """

    def __init__(self, policy=None, manager=None, *, sync=False,
                 registry=None, recorder=None):
        self.policy = policy or SentinelPolicy()
        self.manager = manager
        self.sync = bool(sync)
        self._recorder = recorder
        self._trainer = None
        self._lock = threading.Lock()
        self._pending = []       # [(step, loss_ref)] oldest first
        self._history = []       # recent healthy losses (spike window)
        self._snapshot = None    # pre-step on-device state (skip rung)
        self._snapshot_step = None
        self.skips_taken = 0
        self.rollbacks_taken = 0
        self.last_action = None
        self.anomalies = Counter(
            "training_anomalies",
            prom_name="paddle_training_anomaly_total",
            help="train-loop anomalies detected by the sentinel, by "
                 "kind (naninf|loss_spike) and response "
                 "(skip|rollback|abort)",
        )
        (registry or get_registry()).register_all([self.anomalies])

    # ------------------------------------------------------------- wiring
    @property
    def recorder(self):
        if self._recorder is not None:
            return self._recorder
        from ..observability import get_flight_recorder

        return get_flight_recorder()

    def bind(self, trainer):
        self._trainer = trainer
        return self

    def attach(self, trainer):
        """Convenience: ``sentinel.attach(trainer)`` ==
        ``trainer.attach_sentinel(sentinel)``."""
        trainer.attach_sentinel(self)
        return trainer

    def _note(self, event, **info):
        try:
            self.recorder.note(event, **info)
        except Exception:
            pass

    # ----------------------------------------------------------- trainer hooks
    def before_step(self, step):
        """Called by the trainer BEFORE it gathers/donates state for
        ``step``. Refreshes the skip rung's pre-step snapshot — but
        only while no earlier loss is still unverified, so the
        snapshot always predates the OLDEST step that could turn out
        bad."""
        if not self.policy.skip_enabled() or self._trainer is None:
            return
        with self._lock:
            if self._pending:
                return
        self._snapshot = self._trainer._memory_snapshot()
        self._snapshot_step = int(step) - 1

    def after_step(self, step, loss_ref):
        """Called by the trainer after write-back (and before its
        checkpoint hook). Registers the loss ref and runs a check;
        returns the Action taken for a skip (the trainer must not
        checkpoint a step that was just undone), raises for
        rollback/abort."""
        with self._lock:
            self._pending.append((int(step), loss_ref))
        return self.check()

    # -------------------------------------------------------------- checking
    def check(self, block=None):
        """Inspect pending loss refs (oldest first). ``block=None``
        follows the sentinel's ``sync`` setting; ``block=False`` only
        looks at refs that are already ready. Returns the last Action
        taken this call (or None); raises RollbackAndReplay /
        TrainingAborted per the ladder."""
        block = self.sync if block is None else bool(block)
        taken = None
        while True:
            with self._lock:
                if not self._pending:
                    break
                step, ref = self._pending[0]
            if not block and not value_is_ready(ref):
                break
            try:
                # a DeviceValue reads its tensor (ready: no wait), a CPU
                # tensor or a float reads as itself
                value = float(ref)
            except Exception as e:
                # an unreadable ref (donated, deleted) can't be judged;
                # drop it rather than wedge the sentinel
                self._note("sentinel_unreadable", step=step, error=repr(e))
                with self._lock:
                    self._pending.pop(0)
                continue
            kind = self._classify(value)
            if kind is None:
                with self._lock:
                    self._pending.pop(0)
                    self._history.append(value)
                    if len(self._history) > self.policy.spike_window:
                        del self._history[: -self.policy.spike_window]
                continue
            taken = self._respond(kind, step, value)  # skip returns,
        return taken                                  # others raise

    def _classify(self, value):
        if not np.isfinite(value):
            return KIND_NANINF
        pol = self.policy
        if pol.loss_ceiling is not None and value > pol.loss_ceiling:
            return KIND_LOSS_SPIKE
        with self._lock:
            hist = list(self._history)
        if len(hist) >= pol.min_history:
            med = statistics.median(hist)
            if med > 0 and value > pol.spike_factor * med:
                return KIND_LOSS_SPIKE
        return None

    # ------------------------------------------------------------ responses
    def _respond(self, kind, step, value):
        pol = self.policy
        action = pol.action_for(kind)
        # ladder escalation: each rung only runs when its machinery and
        # budget are actually available
        if action == ACTION_SKIP and (
            self._snapshot is None or self._trainer is None
            or self.skips_taken >= pol.max_skips
        ):
            action = ACTION_ROLLBACK
        if action == ACTION_ROLLBACK and not self._can_rollback():
            action = ACTION_ABORT
        self.anomalies.inc(kind=kind, action=action)
        self._note(
            "train_anomaly", kind=kind, action=action, step=step,
            value=value if np.isfinite(value) else repr(value),
        )
        if action == ACTION_SKIP:
            return self._skip(kind, step, value)
        if action == ACTION_ROLLBACK:
            self._rollback(kind, step, value)  # raises RollbackAndReplay
        self._abort(kind, step, value)         # raises TrainingAborted

    def _can_rollback(self):
        if self.manager is None or \
                self.rollbacks_taken >= self.policy.max_rollbacks:
            return False
        try:
            from ..checkpoint import commit as commit_mod

            return bool(commit_mod.list_committed(self.manager.root))
        except Exception:
            return False

    def _skip(self, kind, step, value):
        with self._lock:
            dropped = len(self._pending)
            self._pending.clear()
        snap, self._snapshot = self._snapshot, None
        resume = self._snapshot_step + 1
        self._trainer._restore_memory_snapshot(snap)
        self.skips_taken += 1
        act = Action(kind, ACTION_SKIP, step, value=value,
                     resume_step=resume, dropped_steps=dropped)
        self.last_action = act
        return act

    def _rollback(self, kind, step, value):
        with self._lock:
            self._pending.clear()
            self._history.clear()
        self._snapshot = None
        self.rollbacks_taken += 1
        try:
            # a save dispatched before detection may still be in
            # flight; let it land so the generation set is final
            # before quarantine + restore below
            self.manager.wait()
        except Exception:
            pass
        # async detection lag means a POISONED step may already have
        # been checkpointed (the trainer only gates the step it judged
        # synchronously): any generation at step >= the anomalous step
        # holds post-anomaly params and must never be restored — or
        # resumed from later. Quarantine renames it onto a .tmp name
        # (discovery never trusts .tmp; startup GC reaps it).
        self._quarantine_poisoned(step)
        res = self.manager.restore_or_init()
        if not res.restored:
            self._abort(kind, step, value)
        act = Action(kind, ACTION_ROLLBACK, step, value=value,
                     resume_step=res.step + 1)
        self.last_action = act
        self._note("train_rollback", step=step, resume_step=act.resume_step)
        raise RollbackAndReplay(act)

    def _quarantine_poisoned(self, bad_step):
        """Retire every committed generation at step >= the anomalous
        step: its params already contain the bad update. The rename
        targets a ``.tmp``-suffixed name so discovery skips it
        immediately and the manager's startup GC reaps it later; in a
        shared-root multi-rank deployment only the first rename wins
        (peers' failures are ignored)."""
        from ..checkpoint import commit as commit_mod

        try:
            committed = commit_mod.list_committed(self.manager.root)
        except Exception:
            return
        for gen_step, path in committed:
            if gen_step < bad_step:
                continue
            try:
                os.rename(
                    path, path + ".anomaly" + commit_mod.TMP_SUFFIX
                )
                self._note("train_quarantine", step=gen_step,
                           path=path, bad_step=bad_step)
            except OSError:
                pass

    def _abort(self, kind, step, value):
        act = Action(kind, ACTION_ABORT, step, value=value)
        self.last_action = act
        path = None
        try:
            # nonblocking materialization: the dump must never deadlock
            # on the dying run's own in-flight refs
            path = self.recorder.dump(
                reason=f"train_anomaly:{kind}", sync=False
            )
        except Exception:
            pass
        raise TrainingAborted(act, bundle_path=path)


# --------------------------------------------------------------- watchdog
class TrainWatchdog:
    """Detect wedged steps and straggling peer ranks before the job
    dies silently.

    - **Wedged step**: :meth:`note_dispatch` timestamps each step
      dispatch (called by the attached trainer — one clock read, no
      sync). :meth:`attach` listens on the StepMeter's
      ``add_blocked_listener``, and a fire marks the next run break
      with ``StepMeter.note_wedged``. :meth:`check` fires when ``clock() - last_dispatch -
      blocked`` exceeds ``stall_seconds``; checkpoint stalls reported
      through the StepMeter's ``note_blocked`` seam are excluded, so
      an emergency save never reads as a hang. One fire per wedge: a
      new dispatch re-arms.
    - **Straggler / dead peer**: when ``heartbeat_dir`` is set (or the
      ``PADDLE_TPU_HEARTBEAT_DIR`` env var — the elastic supervisor
      exports it), each dispatch refreshes this rank's heartbeat file
      (mtime = dispatch recency, the elastic-manager discipline) and
      :meth:`check` fires ``missed_heartbeat`` for any peer whose file
      went stale past ``heartbeat_timeout_s`` — once per staleness
      episode. Peer staleness runs on REAL file mtimes (cross-process
      comparable); the wedge gap runs on the injectable ``clock`` so
      tests advance time instead of sleeping.

    A fire bumps ``paddle_training_watchdog_fires_total{kind}``, marks
    the StepMeter's next run break ``watchdog_fire``, records a flight
    event, dumps a flight bundle (``reason="watchdog:<kind>"``), and
    invokes ``on_fire(kind, **info)`` when given. :meth:`start` runs
    :meth:`check` on a monitor thread every ``poll_interval_s``."""

    KIND_WEDGED = "wedged_step"
    KIND_MISSED = "missed_heartbeat"

    def __init__(self, *, stall_seconds=300.0, clock=time.monotonic,
                 poll_interval_s=None, heartbeat_dir=None, rank=None,
                 heartbeat_timeout_s=None, registry=None, recorder=None,
                 on_fire=None, heartbeat_min_interval_s=0.2):
        self.stall_seconds = float(stall_seconds)
        self.clock = clock
        self.poll_interval_s = (
            float(poll_interval_s) if poll_interval_s is not None
            else max(0.05, min(self.stall_seconds / 4.0, 5.0))
        )
        self.heartbeat_dir = heartbeat_dir or os.environ.get(
            "PADDLE_TPU_HEARTBEAT_DIR"
        )
        self.rank = self._resolve_rank(rank)
        self.heartbeat_timeout_s = (
            float(heartbeat_timeout_s) if heartbeat_timeout_s is not None
            else self.stall_seconds
        )
        self.heartbeat_min_interval_s = float(heartbeat_min_interval_s)
        self._recorder = recorder
        self.on_fire = on_fire
        self._lock = threading.Lock()
        self._last = None
        self._last_step = None
        self._blocked = 0.0
        self._fired_this_gap = False
        self._peer_fired = {}      # rank -> mtime at fire time
        self._hb_last_write = 0.0
        self._stop = threading.Event()
        self._thread = None
        self._meter_undo = None
        self.last_dump_path = None
        self.fires = Counter(
            "training_watchdog_fires",
            prom_name="paddle_training_watchdog_fires_total",
            help="watchdog detections, by kind "
                 "(wedged_step|missed_heartbeat)",
        )
        (registry or get_registry()).register_all([self.fires])
        if self.heartbeat_dir:
            os.makedirs(self.heartbeat_dir, exist_ok=True)

    @staticmethod
    def _resolve_rank(rank):
        if rank is not None:
            return int(rank)
        env = os.environ.get("PADDLE_TRAINER_ID", "").strip()
        if env.isdigit():
            return int(env)
        try:
            import torch.distributed as dist

            return int(dist.get_rank()) if dist.is_initialized() else 0
        except Exception:
            return 0

    @property
    def recorder(self):
        if self._recorder is not None:
            return self._recorder
        from ..observability import get_flight_recorder

        return get_flight_recorder()

    # ------------------------------------------------------------- wiring
    def attach(self, trainer):
        """``trainer.attach_watchdog(self)`` + listen on the process
        StepMeter's blocked seam so checkpoint stalls are excluded
        from the wedge gap."""
        trainer.attach_watchdog(self)
        self._listen_blocked()
        return trainer

    def _listen_blocked(self):
        if self._meter_undo is not None:
            return
        try:
            from ..observability import get_step_meter

            self._meter_undo = get_step_meter().add_blocked_listener(
                self.note_blocked
            )
        except Exception:
            self._meter_undo = None

    # -------------------------------------------------------------- feeding
    def note_dispatch(self, step):
        """One step dispatched (host-side timestamp only)."""
        with self._lock:
            self._last = self.clock()
            self._last_step = int(step)
            self._blocked = 0.0
            self._fired_this_gap = False
        self._write_heartbeat(step)

    def note_blocked(self, seconds):
        """Train-loop stall that is NOT step work (checkpoint writer
        backpressure / emergency save): excluded from the wedge gap."""
        with self._lock:
            self._blocked += float(seconds)

    def _write_heartbeat(self, step):
        if not self.heartbeat_dir:
            return
        now = time.time()
        if now - self._hb_last_write < self.heartbeat_min_interval_s:
            return
        self._hb_last_write = now
        path = os.path.join(self.heartbeat_dir, str(self.rank))
        try:
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                f.write(f"{int(step)}\n")
            os.replace(tmp, path)
        except OSError:
            pass

    # ------------------------------------------------------------- checking
    def check(self):
        """One watchdog pass; returns the list of fires it produced
        (``[(kind, info), ...]``). The monitor thread calls this every
        ``poll_interval_s``; tests with a ChaosClock call it
        directly."""
        fires = []
        now = self.clock()
        with self._lock:
            last = self._last
            blocked = self._blocked
            fired = self._fired_this_gap
            step = self._last_step
        if last is not None and not fired:
            gap = now - last - blocked
            if gap > self.stall_seconds:
                with self._lock:
                    self._fired_this_gap = True
                info = {"step": step, "gap_s": round(gap, 3),
                        "blocked_s": round(blocked, 3)}
                self._fire(self.KIND_WEDGED, **info)
                fires.append((self.KIND_WEDGED, info))
        fires.extend(self._check_peers())
        return fires

    def _check_peers(self):
        fires = []
        if not self.heartbeat_dir:
            return fires
        try:
            names = os.listdir(self.heartbeat_dir)
        except OSError:
            return fires
        now = time.time()
        for name in names:
            if not name.isdigit() or int(name) == self.rank:
                continue
            p = os.path.join(self.heartbeat_dir, name)
            try:
                mtime = os.stat(p).st_mtime
            except OSError:
                continue
            if now - mtime <= self.heartbeat_timeout_s:
                continue
            # monitor-thread state goes under the lock: tests and the
            # attach()ing thread call check() too, and an unlocked dict
            # write races them (unlocked-shared-write)
            with self._lock:
                if self._peer_fired.get(name) == mtime:
                    continue  # already fired for this staleness episode
                self._peer_fired[name] = mtime
            info = {"rank": int(name),
                    "stale_s": round(now - mtime, 3)}
            self._fire(self.KIND_MISSED, **info)
            fires.append((self.KIND_MISSED, info))
        return fires

    def _fire(self, kind, **info):
        self.fires.inc(kind=kind)
        try:
            from ..observability import get_step_meter

            if kind == self.KIND_WEDGED:
                get_step_meter().note_wedged()
        except Exception:
            pass
        try:
            self.recorder.note("watchdog_fire", watchdog_kind=kind,
                               **info)
            # the whole point: the bundle lands BEFORE the job dies
            # silently (nonblocking — the wedged step's refs are by
            # definition not ready)
            path = self.recorder.dump(
                reason=f"watchdog:{kind}", sync=False
            )
            with self._lock:
                # published to other threads (the smoke asserts on it)
                self.last_dump_path = path
        except Exception:
            pass
        if self.on_fire is not None:
            try:
                self.on_fire(kind, **info)
            except Exception:
                pass

    # ------------------------------------------------------------ lifecycle
    def start(self):
        """Run :meth:`check` on a daemon monitor thread."""
        self._listen_blocked()
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="paddle-train-watchdog", daemon=True
        )
        self._thread.start()
        return self

    def _loop(self):
        while not self._stop.wait(self.poll_interval_s):
            try:
                self.check()
            except Exception:
                pass

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if self._meter_undo is not None:
            self._meter_undo()
            self._meter_undo = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False


# ---------------------------------------------------------- training loop
def run_resilient(trainer, batch_fn, *, steps, start_step=1,
                  on_step=None):
    """Drive ``trainer`` from ``start_step`` through ``steps`` with
    rollback-and-replay semantics.

    ``batch_fn(step) -> (inputs, labels)`` is the DATA CURSOR: it must
    be deterministic per step index (the usual seeded-pipeline
    contract), because a rollback rewinds the cursor to the restored
    step and re-feeds the same batches — which is what makes the
    recovered loss trajectory exactly equal an uninterrupted run.

    ``on_step(step, loss, action)`` is called after every completed
    step; ``action`` is the sentinel's Action when this step triggered
    a skip (the step's update was undone and its batch dropped), else
    None. Returns a summary dict. :class:`TrainingAborted` propagates.
    """
    sentinel = getattr(trainer, "_sentinel", None)
    step = int(start_step)
    replays = 0
    completed = 0
    skipped = 0
    while step <= int(steps):
        inputs, labels = batch_fn(step)
        prev_action = sentinel.last_action if sentinel else None
        try:
            loss, _outs = trainer(inputs, labels)
        except RollbackAndReplay as rb:
            replays += 1
            step = int(rb.action.resume_step)
            continue
        action = None
        if sentinel is not None:
            la = sentinel.last_action
            # identity check, not step equality: an async skip fires
            # while verifying an EARLIER step's ref than the cursor
            if la is not None and la is not prev_action \
                    and la.action == ACTION_SKIP:
                action = la
                skipped += la.dropped_steps
        if action is None:
            completed += 1
        if on_step is not None:
            on_step(step, loss, action)
        step += 1
    return {
        "completed_steps": completed,
        "replays": replays,
        "skipped_steps": skipped,
        "final_step": (
            trainer.optimizer._step_count
            if getattr(trainer, "optimizer", None) is not None else None
        ),
    }
