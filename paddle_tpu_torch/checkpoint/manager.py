"""CheckpointManager: policy, async saves, verified restore, preemption
(counterpart of ``paddle_tpu/checkpoint/manager.py``).

The manager owns everything the raw serializer does not decide:

- **when** to save (:class:`CheckpointPolicy`: every N steps and/or
  every S seconds), driven by :meth:`CheckpointManager.on_step` from the
  trainer (``jit.CompiledTrainStep.attach_checkpoint``);
- **how** to save without stalling the card: a snapshot into pinned host
  memory on a side stream (``snapshot.py``) handed to one background
  writer (``async_saver.py``), committed atomically (``commit.py``);
  backpressure and synchronous saves are observed in ``blocked_seconds``
  and the snapshot's own host time in ``snapshot_seconds``;
- **what** to keep: last-K plus every-M-steps retention, orphaned
  ``.tmp`` GC at startup;
- **whether** what came back is intact: :meth:`restore_or_init` verifies
  manifest checksums and falls back to the previous committed checkpoint
  (counted in ``fallbacks_total`` by reason) instead of crashing on a
  torn or bit-rotted save;
- **preemption**: SIGTERM triggers an emergency synchronous save within
  a grace window.

Differences from the JAX manager:

- one process: the process count and index are 1 and 0, so the
  multi-process agreement, barriers and gathers of the JAX manager are
  absent until ``ROADMAP.md`` queue A item 6;
- the metrics register in the process registry (or ``registry=``)
  under JAX's ``paddle_ckpt_*`` names, plus ``snapshot_seconds`` (the
  caller thread's share of an async save); the flight-recorder events
  are JAX's, in the process recorder, and so is the emergency save's
  flight dump under ``root/flight/``;
- the ``rng`` entry: the JAX manager saves the global key's data,
  uint32[2] (``core/random.py:74``). The port has no global key (its
  generators are explicit), so it writes an entry of the same name,
  shape and dtype, ``torch.initial_seed()`` as the key words ``[hi,
  lo]`` (what ``jax.random.PRNGKey`` of that seed holds), so JAX's
  ``restore_or_init`` loads a port checkpoint; on restore the port
  ignores the entry with JAX's "not restorable" warning
  (``ROADMAP.md`` queue C records it);
- the snapshot fence: with the manager attached to a trainer, the
  trainer calls :meth:`fence` before each optimizer update, which makes
  the update wait for the last snapshot's device-to-host copies; a save
  from anywhere else fences at once.
"""
from __future__ import annotations

import logging
import os
import shutil
import signal
import threading
import time

import numpy as np
import torch

from ..distributed.checkpoint.save_load import (
    load_state_dict,
    save_state_dict,
)
from ..observability import get_flight_recorder, get_registry
from ..observability import get_step_meter
from ..serving.metrics import Counter, Gauge, Histogram
from . import commit as commit_mod
from .async_saver import AsyncSaver
from .snapshot import snapshot_state

logger = logging.getLogger("paddle_tpu_torch.checkpoint")

# a .tmp dir younger than this may belong to ANOTHER process's live save
# (launcher-style deployments share the root); startup GC only reaps
# older ones
ORPHAN_TMP_MIN_AGE_S = 300.0

SAVE_SECONDS_BUCKETS = (
    0.01, 0.05, 0.25, 1.0, 5.0, 15.0, 60.0, 300.0, 1800.0,
)


class CheckpointPolicy:
    """When to save and what to keep.

    ``save_every_steps`` / ``save_every_seconds``: either (or both) may
    trigger a save. ``keep_last_k`` bounds disk; ``keep_every_m``
    additionally pins every M-th step."""

    def __init__(self, save_every_steps=None, save_every_seconds=None,
                 keep_last_k=3, keep_every_m=None):
        self.save_every_steps = (
            int(save_every_steps) if save_every_steps else None
        )
        self.save_every_seconds = (
            float(save_every_seconds) if save_every_seconds else None
        )
        self.keep_last_k = max(1, int(keep_last_k))
        self.keep_every_m = int(keep_every_m) if keep_every_m else None

    def should_save(self, step, now, last_saved_step, last_saved_time,
                    include_time=True):
        if step == last_saved_step:
            return False
        if self.save_every_steps is not None and \
                step - last_saved_step >= self.save_every_steps:
            return True
        if include_time and self.save_every_seconds is not None and \
                now - last_saved_time >= self.save_every_seconds:
            return True
        return False

    def retained_steps(self, steps_newest_first):
        keep = set(steps_newest_first[: self.keep_last_k])
        if self.keep_every_m:
            keep.update(
                s for s in steps_newest_first if s % self.keep_every_m == 0
            )
        return keep


class RestoreResult:
    """What :meth:`CheckpointManager.restore_or_init` found."""

    def __init__(self, restored, step, path):
        self.restored = bool(restored)
        self.step = int(step)
        self.path = path

    def __repr__(self):
        return (
            f"RestoreResult(restored={self.restored}, step={self.step}, "
            f"path={self.path!r})"
        )


def _fallback_reason(problems):
    first = problems[0] if problems else ""
    if first.startswith("manifest"):
        return "manifest_missing"
    if first.startswith("missing file"):
        return "missing_shard"
    if first.startswith(("size mismatch", "checksum mismatch")):
        return "checksum_mismatch"
    if first.startswith(("metadata", "shard not covered")):
        return "metadata_error"
    return "load_error"


def _encode_extra_state(data):
    """{key: array-like} -> JSON-safe manifest block: floats as JSON
    doubles, integer and bool dtypes as Python ints (exact past 2^53)."""
    out = {}
    for k, v in data.items():
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        a = np.asarray(v)
        if a.dtype.kind in "iub":
            vals = a.ravel().tolist()
        else:
            vals = a.astype(np.float64).ravel().tolist()
        out[str(k)] = {
            "dtype": str(a.dtype),
            "shape": list(a.shape),
            "data": vals,
        }
    return out


def _decode_extra_state(block):
    out = {}
    for k, rec in block.items():
        dtype = np.dtype(rec.get("dtype", "float32"))
        out[k] = np.asarray(rec["data"], dtype).reshape(
            rec.get("shape", [-1])
        )
    return out


def rng_state():
    """The ``rng`` entry: ``torch.initial_seed()`` as uint32 ``[hi, lo]``
    (the key data ``jax.random.PRNGKey`` of that seed holds)."""
    seed = torch.initial_seed() & ((1 << 64) - 1)
    return np.array([seed >> 32, seed & 0xFFFFFFFF], np.uint32)


class CheckpointManager:
    """Fault-tolerant checkpoint runtime over a checkpoint root dir::

        mgr = CheckpointManager("ckpts", network=net, optimizer=opt,
                                policy=CheckpointPolicy(save_every_steps=100))
        res = mgr.restore_or_init()          # crash-safe auto-resume
        trainer.attach_checkpoint(mgr)
        mgr.install_preemption_handler()     # SIGTERM -> emergency save

    ``state_fn(step)`` may replace the default state assembly (model and
    optimizer state dicts, the step and the ``rng`` entry)."""

    def __init__(self, root, *, network=None, optimizer=None,
                 state_fn=None, policy=None, async_saves=True,
                 registry=None, manifest_extra_fn=None,
                 coordinator_rank=0):
        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)
        self.network = network
        self.optimizer = optimizer
        self._state_fn = state_fn
        self.policy = policy or CheckpointPolicy()
        self.async_saves = bool(async_saves)
        self.coordinator_rank = int(coordinator_rank)
        self._manifest_extra_fn = manifest_extra_fn
        self._serialize = save_state_dict  # test seam: wrap to slow/fault
        self._extra_states = {}            # name -> (get_fn, set_fn)
        self._last_restore_manifest = None
        self._lock = threading.Lock()
        self._last_step = 0
        self._last_saved_step = 0  # steps are 1-based: first save at N
        self._last_saved_time = time.monotonic()
        # set by a trainer that calls fence() before each update
        self._step_fences = False
        self._unfenced = None
        self.preempted = False
        self._prev_handlers = {}
        self._preempt_rethrow = {}
        self._preempt_thread = None
        self._init_metrics(registry or get_registry())
        self._saver = (
            AsyncSaver(on_error=self._on_writer_error)
            if self.async_saves else None
        )
        if self._should_gc_orphans():
            removed = commit_mod.gc_orphans(
                self.root, min_age_s=ORPHAN_TMP_MIN_AGE_S
            )
            for p in removed:
                logger.warning("checkpoint: removed orphaned save %s", p)
                self.fallbacks_total.inc(label="orphan_tmp")
                self._note_event("checkpoint_orphan_gc", path=p)

    # ------------------------------------------------------------- plumbing
    def _init_metrics(self, reg):
        self.registry = reg
        self.save_seconds = Histogram(
            "ckpt_save_seconds", unit="s", buckets=SAVE_SECONDS_BUCKETS,
            prom_name="paddle_ckpt_save_seconds",
            help="wall time of one checkpoint write+commit (writer-side)",
        )
        self.blocked_seconds = Histogram(
            "ckpt_blocked_seconds", unit="s",
            prom_name="paddle_ckpt_blocked_seconds",
            help="train-loop stalls caused by checkpointing (writer "
                 "backpressure, synchronous/emergency saves) — excluded "
                 "from paddle_training_step_time_seconds",
        )
        # the caller thread's share of an async save (the pinned buffer
        # and the copies' launch): the JAX snapshot's is microseconds
        self.snapshot_seconds = Histogram(
            "ckpt_snapshot_seconds", unit="s",
            prom_name="paddle_ckpt_snapshot_seconds",
            help="caller-thread time of one save's snapshot (pinned "
                 "buffers and the device-to-host copies' launch)",
        )
        self.bytes_total = Counter(
            "ckpt_bytes", prom_name="paddle_ckpt_bytes_total",
            help="checkpoint bytes committed to storage",
        )
        self.saves_total = Counter(
            "ckpt_saves", labelname="mode",
            prom_name="paddle_ckpt_saves_total",
            help="committed checkpoints by mode (async|sync|emergency)",
        )
        self.save_failures_total = Counter(
            "ckpt_save_failures",
            prom_name="paddle_ckpt_save_failures_total",
            help="checkpoint saves that errored (training continued)",
        )
        self.last_step = Gauge(
            "ckpt_last_step", prom_name="paddle_ckpt_last_step",
            help="step of the newest committed checkpoint",
        )
        self.fallbacks_total = Counter(
            "ckpt_restore_fallbacks", labelname="reason",
            prom_name="paddle_ckpt_restore_fallbacks_total",
            help="restore candidates rejected (torn/corrupt/orphaned) "
                 "by reason",
        )
        self.restores_total = Counter(
            "ckpt_restores", labelname="outcome",
            prom_name="paddle_ckpt_restores_total",
            help="restore_or_init outcomes (restored|init)",
        )
        reg.register_all([
            self.save_seconds, self.blocked_seconds, self.snapshot_seconds,
            self.bytes_total, self.saves_total, self.save_failures_total,
            self.last_step, self.fallbacks_total, self.restores_total,
        ])

    @staticmethod
    def _note_event(kind, **info):
        try:
            get_flight_recorder().note(kind, **info)
        except Exception:
            pass

    def _note_blocked(self, seconds, reason):
        """A train-loop stall attributable to checkpointing: publish the
        dedicated histogram and tell the StepMeter to EXCLUDE it from
        the next step_time interval, so tokens/sec and MFU are not
        silently deflated by save stalls."""
        self.blocked_seconds.observe(seconds)
        try:
            get_step_meter().note_blocked(seconds)
        except Exception:
            pass
        self._note_event(
            "checkpoint_blocked", seconds=seconds, reason=reason
        )

    def _should_gc_orphans(self):
        """Startup GC touches a shared directory: under a launcher every
        rank is its own single-process world, so only the coordinator's
        rank (``PADDLE_TRAINER_ID``) reaps (the age window in
        ``gc_orphans`` is the second guard)."""
        env_rank = os.environ.get("PADDLE_TRAINER_ID", "").strip()
        if env_rank.isdigit():
            return int(env_rank) == self.coordinator_rank
        return True

    def _on_writer_error(self, exc):
        self.save_failures_total.inc()
        self._note_event("checkpoint_save_failed", error=repr(exc))
        logger.error("checkpoint: background save failed: %r", exc)

    # ---------------------------------------------------------------- state
    def bind(self, network=None, optimizer=None):
        """Late binding for managers constructed before the model."""
        if network is not None and self.network is None:
            self.network = network
        if optimizer is not None and self.optimizer is None:
            self.optimizer = optimizer
        return self

    def register_extra_state(self, name, get_fn, set_fn):
        """Attach a small named side-state that must survive a resume but
        lives outside the model/optimizer state dicts. ``get_fn()``
        returns ``{key: array-like}`` (empty = nothing this save); it is
        stored in the commit manifest's ``extra`` block. On restore,
        ``set_fn`` receives the decoded ``{key: np array}``. Registration
        after a restore applies the restored state at once."""
        self._extra_states[name] = (get_fn, set_fn)
        man = self._last_restore_manifest
        if man:
            data = ((man.get("extra") or {}).get("state") or {}).get(
                name
            )
            if data is not None:
                try:
                    set_fn(_decode_extra_state(data))
                except Exception as e:
                    logger.warning(
                        "checkpoint: restored extra state %r not "
                        "applicable: %r", name, e,
                    )
        return self

    def _collect_extra_state(self):
        out = {}
        for name, (get_fn, _set) in self._extra_states.items():
            try:
                data = get_fn()
                if data:
                    out[name] = _encode_extra_state(data)
            except Exception as e:
                logger.warning(
                    "checkpoint: extra state %r not captured: %r",
                    name, e,
                )
        return out

    def _build_state(self, step):
        if self._state_fn is not None:
            return self._state_fn(step)
        if self.network is None:
            raise RuntimeError(
                "CheckpointManager has no network bound and no state_fn; "
                "pass network=/optimizer= or state_fn= at construction, "
                "or bind() before saving"
            )
        state = {"model": self.network.state_dict()}
        if self.optimizer is not None:
            state["opt"] = self.optimizer.state_dict()
        state["step"] = int(step if step is not None else self._last_step)
        state["rng"] = rng_state()
        return state

    # ---------------------------------------------------------------- saves
    def on_step(self, step):
        """Per-step hook (the trainer): updates the step clock and saves
        when the policy says so. Returns True if a save was triggered."""
        step = int(step)
        now = time.monotonic()
        with self._lock:
            self._last_step = step
            last_step = self._last_saved_step
            last_time = self._last_saved_time
        if self.policy.should_save(step, now, last_step, last_time):
            self.save(step)
            return True
        return False

    def fence(self):
        """Make the caller's current stream wait for the last snapshot's
        device-to-host copies (the trainer calls it before each optimizer
        update, which writes the snapshotted tensors in place)."""
        with self._lock:
            snap, self._unfenced = self._unfenced, None
        if snap is not None:
            snap.fence()

    def save(self, step=None, blocking=None, mode=None):
        """Checkpoint the current state at ``step``. ``blocking=False``
        (the async default) snapshots on the caller thread and hands the
        write to the background writer; ``blocking=True`` writes and
        commits before returning."""
        step = int(self._last_step if step is None else step)
        if blocking is None:
            blocking = not self.async_saves
        mode = mode or ("sync" if blocking else "async")
        t0 = time.perf_counter()
        state = self._build_state(step)
        snap = snapshot_state(state, fence_now=not self._step_fences)
        self.snapshot_seconds.observe(time.perf_counter() - t0)
        extra_state = self._collect_extra_state()
        with self._lock:
            prev = (self._last_saved_step, self._last_saved_time)
            self._last_saved_step = step
            self._last_saved_time = time.monotonic()
            if self._step_fences:
                self._unfenced = snap

        def write():
            # the saved-marker was advanced optimistically; a failed
            # write rolls it back
            try:
                self._write_and_commit(step, snap, mode, extra_state)
            except BaseException:
                with self._lock:
                    if self._last_saved_step == step:
                        (self._last_saved_step,
                         self._last_saved_time) = prev
                raise

        if blocking or self._saver is None:
            t0 = time.perf_counter()
            write()
            self._note_blocked(time.perf_counter() - t0, reason=mode)
        else:
            blocked = self._saver.submit(write)
            if blocked > 1e-4:
                # backpressure: the previous save was still in flight
                self._note_blocked(blocked, reason="backpressure")
        return step

    def _write_and_commit(self, step, snap, mode, extra_state=None):
        """Writer side: wait for the snapshot's copies, serialize into
        step_N.tmp, write the manifest, rename."""
        t0 = time.perf_counter()
        tmp = commit_mod.tmp_dir(self.root, step)
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp, exist_ok=True)
        snap.wait()
        files = self._serialize(snap, tmp) or {}
        extra = (
            self._manifest_extra_fn(step, snap)
            if self._manifest_extra_fn is not None else None
        )
        if extra_state:
            extra = dict(extra or {})
            extra["state"] = extra_state
        commit_mod.write_manifest(tmp, step, files, extra=extra)
        path = commit_mod.commit(self.root, step)
        self._apply_retention()
        dt = time.perf_counter() - t0
        nbytes = sum(int(rec["bytes"]) for rec in files.values())
        self.save_seconds.observe(dt)
        self.bytes_total.inc(nbytes)
        self.saves_total.inc(label=mode)
        self.last_step.set(step)
        self._note_event(
            "checkpoint_commit", step=step, seconds=dt, bytes=nbytes,
            mode=mode, path=path or commit_mod.step_dir(self.root, step),
        )
        return path

    def _apply_retention(self):
        committed = commit_mod.list_committed(self.root)
        keep = self.policy.retained_steps([s for s, _ in committed])
        for s, path in committed:
            if s not in keep:
                shutil.rmtree(path, ignore_errors=True)
                self._note_event("checkpoint_retired", step=s, path=path)

    def wait(self, timeout=None):
        """Drain any in-flight background save."""
        if self._saver is not None:
            return self._saver.wait(timeout)
        return True

    def finalize(self):
        """End of training: drain the writer (and any emergency save) so
        the last commit lands."""
        self.join_preemption()
        self.wait()
        if self._saver is not None and self._saver.last_error is not None:
            logger.error(
                "checkpoint: last background save error: %r",
                self._saver.last_error,
            )

    def close(self):
        self.finalize()
        if self._saver is not None:
            self._saver.close()

    # -------------------------------------------------------------- restore
    def restore_or_init(self):
        """Crash-safe auto-resume: load the newest INTACT committed
        checkpoint into the bound network and optimizer, or leave the
        fresh init in place when none exists. Every candidate is verified
        against its manifest first; a torn or corrupted one is logged,
        counted in ``fallbacks_total`` by reason, and skipped."""
        state = self._build_state(None)
        for step, path, manifest in commit_mod.list_candidates(self.root):
            if manifest is None:
                self._reject(path, ["manifest missing or unparsable"])
                continue
            problems = commit_mod.verify_checkpoint(path)
            if problems:
                self._reject(path, problems)
                continue
            try:
                load_state_dict(state, path)
            except Exception as e:
                self._reject(path, [f"load failed: {e!r}"],
                             reason="load_error")
                continue
            if self.optimizer is not None and isinstance(
                state.get("opt"), dict
            ):
                self.optimizer.set_state_dict(state["opt"])
            if state.get("rng") is not None and self._state_fn is None:
                # the port's generators are explicit: no global key
                logger.warning(
                    "checkpoint: RNG state from %s not restorable", path,
                )
            restored_step = int(state.get("step", step))
            with self._lock:
                self._last_step = restored_step
                self._last_saved_step = restored_step
                self._last_saved_time = time.monotonic()
            self._last_restore_manifest = manifest
            extra = (manifest.get("extra") or {}).get("state") or {}
            for name, (_get, set_fn) in self._extra_states.items():
                data = extra.get(name)
                if data is None:
                    continue
                try:
                    set_fn(_decode_extra_state(data))
                except Exception as e:
                    logger.warning(
                        "checkpoint: extra state %r from %s not "
                        "applicable: %r", name, path, e,
                    )
            self.restores_total.inc(label="restored")
            self._note_event(
                "checkpoint_restore", step=restored_step, path=path
            )
            logger.info(
                "checkpoint: resumed from %s (step %d)", path, restored_step
            )
            return RestoreResult(True, restored_step, path)
        self.restores_total.inc(label="init")
        self._note_event("checkpoint_restore", step=0, path=None)
        return RestoreResult(False, 0, None)

    def _reject(self, path, problems, reason=None):
        reason = reason or _fallback_reason(problems)
        self.fallbacks_total.inc(label=reason)
        self._note_event(
            "checkpoint_fallback", path=path, reason=reason,
            problems=problems[:4],
        )
        logger.warning(
            "checkpoint: skipping %s (%s): %s", path, reason, problems[:4]
        )

    # ----------------------------------------------------------- preemption
    def install_preemption_handler(self, signals=(signal.SIGTERM,),
                                   grace_seconds=30.0):
        """SIGTERM (preemption notice) -> drain any in-flight save within
        the grace window, then take an emergency synchronous save of the
        current step on a dedicated thread. Sets :attr:`preempted` for the
        train loop to exit; a previous callable handler is honoured after
        the save lands by re-raising the signal with it restored."""
        grace_seconds = float(grace_seconds)

        def handler(signum, frame, _grace=grace_seconds):
            if self._preempt_rethrow.pop(signum, None):
                prev = self._prev_handlers.get(signum)
                signal.signal(
                    signum, prev if prev is not None else signal.SIG_DFL
                )
                signal.raise_signal(signum)
                return
            self.preempted = True
            if self._preempt_thread is not None and \
                    self._preempt_thread.is_alive():
                return  # a second notice while the save is running
            prev = self._prev_handlers.get(signum)

            def run():
                self.emergency_save(grace_seconds=_grace)
                if callable(prev) and prev is not handler:
                    self._preempt_rethrow[signum] = True
                    os.kill(os.getpid(), signum)

            self._preempt_thread = threading.Thread(
                target=run, name="ckpt-preempt", daemon=False
            )
            self._preempt_thread.start()

        for sig in signals:
            self._prev_handlers[sig] = signal.signal(sig, handler)
        return self

    def join_preemption(self, timeout=None):
        """Wait for an in-progress emergency save. Returns True when no
        emergency save is running."""
        t = self._preempt_thread
        if t is None:
            return True
        t.join(timeout)
        return not t.is_alive()

    def emergency_save(self, grace_seconds=30.0):
        """Synchronous best-effort save of the current step (preemption
        path). Never raises. The flight recorder's bundle is dumped next
        to the checkpoints (``root/flight/``) either way."""
        t0 = time.perf_counter()
        try:
            drained = self.wait(timeout=grace_seconds)
            if not drained:
                logger.error(
                    "checkpoint: in-flight save did not drain within "
                    "%.0fs grace; emergency save skipped", grace_seconds
                )
                return None
            with self._lock:
                already = self._last_saved_step == self._last_step
            if already:
                return self._last_step
            return self.save(blocking=True, mode="emergency")
        except Exception as e:
            self.save_failures_total.inc()
            self._note_event("checkpoint_save_failed", error=repr(e),
                             mode="emergency")
            logger.error("checkpoint: emergency save failed: %r", e)
            return None
        finally:
            self._note_event(
                "checkpoint_preempted",
                seconds=time.perf_counter() - t0,
                step=self._last_step,
            )
            # nonblocking: a step may still be in flight inside the grace
            # window; under root/flight/, where no step directory is
            try:
                path = get_flight_recorder().dump(
                    path=os.path.join(
                        self.root, "flight",
                        f"preemption_{os.getpid()}.json",
                    ),
                    reason="preemption", sync=False,
                )
                self._note_event("flight_dump", path=path,
                                 reason="preemption")
            except Exception:
                pass

    # -------------------------------------------------------------- context
    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False
