"""``CompiledTrainStep``: one optimizer step per call (counterpart of
``paddle_tpu/jit/trainer.py``).

The name is the JAX package's, so a reader finds the counterpart; here
the step runs eagerly (capturing it in a CUDA graph is later work: the
update kernels take their pointers as kernel arguments and read the
scalars that change from step to step from device memory, so they can be
captured as they are). Each call runs, in the order of the JAX step
(``trainer.py:319-560``):

1. the forward and the loss, under the O1 casts when ``amp_level`` is
   "O1", "O2" or "O3" in ``amp_dtype`` (bfloat16 or float16; O2 behaves
   as O1 inside the step, as in the JAX trainer: the parameters keep the
   dtype they have, fp32 unless ``amp.decorate`` cast them); O3 also arms
   ``amp.fp8.fp8_autocast`` with the carried amax histories, so every
   ``F.linear`` multiplies fp8 operands (e4m3 forward, e5m2 gradient,
   delayed scaling; ``amp/fp8.py``, JAX ``trainer.py:320-361``); with a
   ``scaler``, the loss times the loss scale;
2. the backward through torch autograd (the RMSNorm, rope and flash
   attention kernels' backward kernels on the card); a parameter the loss
   does not reach gets a zero gradient, as ``jax.value_and_grad`` gives
   it;
3. the optimizer layer, every parameter the optimizer owns, through the
   multi-tensor kernels (``kernels/fused_adam.py``): one ``mt_sumsq``
   pass when the scaler or a norm clip needs it (the unscale ``G(g *
   1/scale)``, the finite check, the norms), then one update call a
   ``(lr x multiplier, weight decay)`` bucket, each of which unscales,
   clips (every gradient: the step does not read ``need_clip``) and
   decays as it updates. With a scaler and a non-finite gradient the
   update writes nothing.

With a scaler, and only then, the step reads one value back, the finite
flag (JAX reads back the new scale, counts and flag, ``trainer.py:815-
825``), and updates the scale and the good and bad counts by the JAX
step's fp32 formulas (``:527-556``); a skipped step does not count as an
optimizer step. Without one, nothing is read back. The scheduler is not
stepped here; the caller steps it, as in the JAX package. Returns ``(loss,
outputs)``: the fp32 loss (unscaled) and the network's outputs, detached.

``attach_checkpoint(manager)`` binds a ``checkpoint.CheckpointManager``
(``trainer.py:110-130``): after each step the manager's policy decides on
a save (``on_step(optimizer._step_count)``, ``:859-864``), and before
each update the step fences the last snapshot (``manager.fence()``), so
the update, which writes parameters and moments in place, waits for the
snapshot's device-to-host copies while the forward and backward overlap
them; it also registers the O3 amax histories as the manager's ``"fp8"``
extra state (:meth:`fp8_state_dict`, :meth:`load_fp8_state`), so an O3
resume continues with the saved scales.

Under O3 the histories (``{"linear<n>/x" | "linear<n>/w": [16] fp32}``,
device tensors) are made at the first step from the sites the forward
meets, each starting empty (scale 1), as JAX's ``eval_shape`` discovery
gives them (``trainer.py:794-806``); each step replaces them with the
forward's updated ones after the backward. Nothing is read back for
them.

``attach_sentinel(sentinel)`` and ``attach_watchdog(watchdog)`` wire the
resilient runtime (``training/resilience.py``, JAX ``trainer.py:132-148``):
before each step the sentinel may take its pre-step snapshot
(:meth:`_memory_snapshot`: device copies of the parameters, buffers,
every optimizer accumulator and the O3 histories, enqueued on the step's
stream before the update writes them in place, plus the step count and
the scaler's state), the watchdog timestamps the dispatch and the chaos seam
``train.step_begin`` fires; after it the loss passes the value seam
``train.loss`` and goes to the sentinel as a lazy device value (a CUDA
event a step), which may undo the step (:meth:`_restore_memory_snapshot`,
copies back into the same storage) or raise for a rollback or an abort;
a step the sentinel undid is not checkpointed.

Each step is published into the process ``StepMeter``
(``observability.get_step_meter()``, JAX ``trainer.py:717-740``): batch
geometry from the inputs' shapes, the loss as a lazy device value, the
first call as ``warmup``. A host clock that stops at the step's last
launch would overstate throughput and MFU on a card, and a
synchronization would slow the loop, so on a card the step's time is
taken between two CUDA events recorded at its start and end, and the
step is published once its end event has completed: at a later call,
or at :meth:`flush_telemetry`. On the CPU the host clock is the step's
time and the step is published at once. Telemetry never fails a step.

With ``FLAGS_check_nan_inf`` on (``utils.flags``), every op of the
forward and the backward is swept (``amp/naninf.py``) without a read
back per op: each op's finite flag stays on the device, and the step
reads them once after the backward, before the update, and raises
naming the first op whose output was not finite (JAX's traced check
raises when the step executes, so its update never lands either).

The optimizers JAX runs only eagerly (``EagerOptimizer``,
``optimizer/optimizer.py``: Adagrad, RMSProp, Adadelta, Adamax, NAdam,
RAdam, ASGD, Rprop, LBFGS) are refused with JAX's message.
"""
from __future__ import annotations

import collections
import contextlib
import time

import numpy as np
import torch

from .. import chaos as _chaos
from .. import optimizer as opt_mod
from ..amp import fp8 as _fp8_mod
from ..amp import naninf as _naninf
from ..amp.auto_cast import auto_cast

_F32 = np.float32


class CompiledTrainStep:
    """Build once per (network, loss, optimizer); call with batches."""

    SUPPORTED = (
        opt_mod.AdamW,  # subclasses before their parents
        opt_mod.Adam,
        opt_mod.Lamb,
        opt_mod.Momentum,
        opt_mod.SGD,
    )

    def __init__(self, network, loss_fn, optimizer, amp_level=None,
                 amp_dtype="bfloat16", scaler=None, layout_policy=None):
        if not any(isinstance(optimizer, cls) for cls in self.SUPPORTED):
            raise NotImplementedError(
                f"CompiledTrainStep does not support "
                f"{type(optimizer).__name__}; use the eager path"
            )
        if amp_level not in (None, "O0", "O1", "O2", "O3"):
            raise NotImplementedError(
                f"amp_level {amp_level!r} is not one of None, O0, O1, O2, "
                f"O3")
        if layout_policy is not None:
            raise NotImplementedError(
                "layout_policy is not ported: sharded layouts wait for the "
                "distributed port (ROADMAP.md queue A item 6)")
        self.network = network
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.amp_level = amp_level
        self.amp_dtype = amp_dtype
        self.scaler = self._normalize_scaler(scaler)
        self._plan = None
        self._inv = {}
        self._checkpoint = None
        self._sentinel = None
        self._watchdog = None
        self._telemetry = collections.deque()  # steps not published yet
        self._calls = 0
        # AMP O3: the delayed-scaling amax histories, carried from step to
        # step (made at the first step)
        self._fp8_state = None
        self._fp8_bytes_saved = 0

    def attach_checkpoint(self, manager):
        """Wire a ``checkpoint.CheckpointManager`` into the step loop: it
        is bound to this trainer's network and optimizer if it was built
        bare, fenced before each update and stepped after it. Returns the
        manager."""
        manager.bind(self.network, self.optimizer)
        manager._step_fences = True
        self._checkpoint = manager
        manager.register_extra_state("fp8", self.fp8_state_dict,
                                     self.load_fp8_state)
        return manager

    def attach_sentinel(self, sentinel):
        """Wire a ``training.AnomalySentinel`` into the step loop: it sees
        every step's loss as a lazy device value and walks its
        skip/rollback/abort ladder on a NaN/inf loss or a spike. Its own
        checkpoint manager (if any) is what a rollback restores from;
        :meth:`attach_checkpoint` wires saving separately. Returns the
        sentinel."""
        sentinel.bind(self)
        self._sentinel = sentinel
        return sentinel

    def attach_watchdog(self, watchdog):
        """Wire a ``training.TrainWatchdog``: each step's dispatch is
        timestamped (one host clock read), so a wedged step or a
        straggling peer fires before the job dies silently. Returns the
        watchdog."""
        self._watchdog = watchdog
        return watchdog

    # -------------------------------------------------- sentinel snapshots
    def _memory_snapshot(self):
        """The sentinel's pre-step snapshot for its skip rung (JAX
        ``trainer.py:150-180``): a device copy of every parameter, buffer
        and optimizer accumulator, enqueued on the current stream (so
        before this step's in-place update; no host sync), with the step
        count and the scaler's state. The RNG is not captured: a skipped
        batch keeps later draws where they would have been."""
        opt = self.optimizer
        with torch.no_grad():
            snap = {
                "params": [(p, p.detach().clone())
                           for p in self.network.parameters()],
                "buffers": [(b, b.clone()) for b in self.network.buffers()],
                "opt_state": {k: v.clone()
                              for k, v in opt._accumulators.items()},
                "fp8": (None if self._fp8_state is None else
                        {k: v.clone() for k, v in self._fp8_state.items()}),
                "step_count": opt._step_count,
            }
        if self.scaler is not None:
            sc = self.scaler
            snap["scaler"] = (sc._scale, sc._good_steps, sc._bad_steps)
        return snap

    def _restore_memory_snapshot(self, snap):
        """Undo the steps since ``snap`` was taken (skip-step, JAX
        ``trainer.py:182-200``), copying into the same storage (the
        optimizer's and the checkpoint snapshot's tensors stay valid). An
        accumulator born after the snapshot returns to its birth value,
        zeros."""
        opt = self.optimizer
        if self._checkpoint is not None:
            # the last save's device-to-host copies read these tensors
            self._checkpoint.fence()
        with torch.no_grad():
            for t, v in snap["params"] + snap["buffers"]:
                t.copy_(v)
            for k, acc in opt._accumulators.items():
                old = snap["opt_state"].get(k)
                if old is None:
                    acc.zero_()
                else:
                    acc.copy_(old)
        if "fp8" in snap:
            # the histories are replaced, never written in place; a
            # snapshot taken before the first O3 step restores none, so
            # the next step starts from empty histories again (scale 1)
            self._fp8_state = (None if snap["fp8"] is None
                               else dict(snap["fp8"]))
        opt._step_count = snap["step_count"]
        if self.scaler is not None and "scaler" in snap:
            (self.scaler._scale, self.scaler._good_steps,
             self.scaler._bad_steps) = snap["scaler"]

    def fp8_state_dict(self):
        """The AMP O3 delayed-scaling state as host numpy arrays
        (``{site/operand: amax history}``), for saving beside a
        checkpoint; empty when O3 is off or no step ran yet."""
        if self._fp8_state is None:
            return {}
        return {k: v.detach().cpu().numpy()
                for k, v in self._fp8_state.items()}

    def load_fp8_state(self, state):
        """Restore histories saved by :meth:`fp8_state_dict` (the keys
        must be the model's sites: the same architecture and call order),
        onto the network's device."""
        if not state:
            return
        dev = next(self.network.parameters()).device
        self._fp8_state = {
            k: torch.as_tensor(np.asarray(v), dtype=torch.float32,
                               device=dev)
            for k, v in state.items()}

    @staticmethod
    def _normalize_scaler(scaler):
        """A disabled GradScaler is the same as no scaler."""
        if scaler is not None and getattr(scaler, "_enable", True):
            return scaler
        return None

    def _amp(self):
        if self.amp_level in ("O1", "O2", "O3"):
            # every level casts as O1 (auto_cast records it, as JAX's)
            return auto_cast(True, level=self.amp_level,
                             dtype=self.amp_dtype)
        return contextlib.nullcontext()

    def _fp8(self):
        if self.amp_level == "O3":
            return _fp8_mod.fp8_autocast(self._fp8_state)
        return contextlib.nullcontext()

    def _build_plan(self):
        """``{id(p): (weight decay, lr multiplier)}``, fixed at the first
        call as the JAX step fixes them at its trace (``trainer.py:284-
        307``); an L1 decay is refused there, as in JAX."""
        opt = self.optimizer
        plan = {}
        for group, p in opt._all_params():
            coeff, l1 = opt._in_step_decay(group, p)
            if l1:
                raise NotImplementedError(
                    "CompiledTrainStep does not support L1Decay "
                    f"(parameter {opt.param_name(p)!r}); use the eager "
                    "optimizer path")
            plan[id(p)] = (float(coeff), opt.lr_multiplier(group, p))
        return plan

    def _inv_scale(self, device, scale):
        """The fp32 device scalar ``1 / scale`` (``trainer.py:407``)."""
        buf = self._inv.get(device)
        if buf is None:
            buf = self._inv[device] = torch.empty(
                (), dtype=torch.float32, device=device)
        return buf.fill_(float(_F32(1) / _F32(scale)))

    def _update_scaler(self, finite):
        """The JAX step's scale update in fp32 (``trainer.py:527-556``)."""
        sc = self.scaler
        scale = _F32(sc._scale)
        good = sc._good_steps + 1 if finite else 0
        bad = 0 if finite else sc._bad_steps + 1
        scale2 = scale
        if sc._dynamic:
            if good >= sc._incr_every:
                scale2 = scale * _F32(sc._incr_ratio)
                good = 0
            if bad >= sc._decr_every:
                scale2 = max(scale * _F32(sc._decr_ratio), _F32(1.0))
                bad = 0
        sc._scale = float(scale2)
        sc._good_steps = good
        sc._bad_steps = bad
        sc._found_inf = not finite
        if not finite:
            # the update was skipped: the bias-correction step stays
            self.optimizer._step_count -= 1

    # ------------------------------------------------------------ telemetry
    def _begin_telemetry(self, device):
        """The step's start mark: a CUDA event on the card, else the host
        clock."""
        if device.type != "cuda":
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _end_telemetry(self, start, inputs, loss):
        try:
            warmup = self._calls == 0
            self._calls += 1
            if isinstance(start, float):
                end = time.perf_counter()
            else:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
            self._telemetry.append((start, end, inputs, loss, warmup))
            self.flush_telemetry(wait=False)
        except Exception:
            pass

    def flush_telemetry(self, wait=True):
        """Publish the steps whose time is known into the process
        ``StepMeter``, oldest first: every pending step with ``wait``
        (its end event is waited for), else those whose end event has
        completed (a query, no synchronization). Returns how many are
        still pending."""
        from .. import observability as obs

        pending = self._telemetry
        try:
            meter = obs.get_step_meter()
            meter.auto_configure(self.network)  # MFU from model config
            while pending:
                start, end, inputs, loss, warmup = pending[0]
                if isinstance(start, float):
                    dt = end - start
                else:
                    if not wait and not end.query():
                        break
                    end.synchronize()
                    dt = start.elapsed_time(end) / 1e3
                pending.popleft()
                examples, tokens = obs.batch_geometry(inputs)
                meter.observe_step(dt, examples=examples, tokens=tokens,
                                   loss=loss, warmup=warmup)
                if self.amp_level == "O3" and self._fp8_bytes_saved:
                    # the analytic per-step HBM delta of the fp8 weights
                    meter.note_fp8_bytes_saved(self._fp8_bytes_saved)
        except Exception:
            pending.clear()
        return len(pending)

    def __call__(self, inputs, labels):
        """One optimizer step over ``inputs`` (the network's positional
        arguments) and ``labels`` (the loss function's arguments after
        the network's outputs)."""
        opt = self.optimizer
        step_next = opt._step_count + 1
        if self._sentinel is not None:
            # the skip rung's pre-step snapshot, enqueued before this
            # step's update writes the tensors in place
            self._sentinel.before_step(step_next)
        if self._watchdog is not None:
            self._watchdog.note_dispatch(step_next)
        # chaos seam: a blocking callback here is the deterministic
        # wedged step
        _chaos.poke("train.step_begin", step=step_next)
        mark = self._begin_telemetry(next(self.network.parameters()).device)
        if self._plan is None:
            self._plan = self._build_plan()
        opt.clear_grad()
        self.network.train()
        sc = self.scaler
        with _naninf.deferred() as sweep:
            with self._amp(), self._fp8() as fp8_ctx:
                out = self.network(*inputs)
                outs = list(out) if isinstance(out, (list, tuple)) else [out]
                loss = self.loss_fn(*outs, *labels).float()
            if sc is not None:
                (loss * float(_F32(sc._scale))).backward()
            else:
                loss.backward()
        if sweep is not None:
            # the step's one read of the sweep's flags, before the update
            sweep.check()
        if fp8_ctx is not None:
            # the histories with this step's amaxes, device tensors
            self._fp8_bytes_saved = fp8_ctx.weight_bytes_saved
            self._fp8_state = fp8_ctx.new_state
        items = [(p, torch.zeros_like(p) if p.grad is None else p.grad, g)
                 for g, p in opt._all_params()]
        opt._step_count += 1
        inv = (None if sc is None
               else self._inv_scale(items[0][0].device, sc._scale))
        if self._checkpoint is not None:
            self._checkpoint.fence()
        stats = opt._apply(items, opt.get_lr(), plan=self._plan, inv=inv)
        if sc is not None:
            self._update_scaler(stats.finite())
        opt.clear_grad()
        loss = loss.detach()
        # chaos value seam: a callback returning float("nan") is the
        # deterministic anomaly the sentinel's ladder must recover from
        injected = _chaos.poke_value("train.loss", loss,
                                     step=opt._step_count)
        if injected is not loss:
            loss = torch.as_tensor(injected, dtype=torch.float32,
                                   device=loss.device)
        self._end_telemetry(mark, inputs, loss)
        action = None
        if self._sentinel is not None:
            from ..observability.registry import device_value

            # may raise RollbackAndReplay (restored to the last commit) or
            # TrainingAborted (bundle dumped); returns the Action of a skip
            action = self._sentinel.after_step(opt._step_count,
                                               device_value(loss))
        if self._checkpoint is not None and action is None:
            # after the sentinel's verdict: a step it undid is not saved
            self._checkpoint.on_step(opt._step_count)
        return loss, [o.detach() for o in outs]
