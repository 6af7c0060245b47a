"""Training-step telemetry: step time, throughput, MFU, memory gauges.

A :class:`StepMeter` is the training-side counterpart of
``serving.ServingMetrics``: one instrument set publishing into the
process registry. ``jit.trainer.CompiledTrainStep`` and the hapi eager
path call :meth:`StepMeter.observe_step` once per optimizer step with
the host-measured wall time and batch geometry; everything derived —
tokens/sec, examples/sec, the analytic-FLOPs MFU estimate — is computed
on the host from those numbers. The loss (and grad norm, when a caller
has one) are stored as LAZY gauge values: the device scalar is kept as
a reference and only fetched when a scrape materializes it, so metering
never adds a device round trip to the hot loop (the same rule hapi's
lazy logs follow).

MFU uses the standard analytic transformer accounting
(:func:`analytic_flops_per_token` — 2N matmul FLOPs per token forward,
3x for forward+backward, plus the attention ``4*s*h*L`` term) against a
per-device peak from the device kind (override with ``peak_flops=`` or
``PADDLE_TPU_PEAK_FLOPS``). On CPU CI there is no meaningful peak, so
MFU only reports when a peak is known or supplied.

Device-memory gauges sample the caching allocator's statistics
(``torch.cuda.memory_stats()``); sampling is throttled to every
``memory_every`` steps.

The PyTorch port's copy of ``paddle_tpu/observability/step_meter.py``.
Where JAX reads the device kind, the port reads
``torch.cuda.get_device_name()`` against the same table ("NVIDIA H100
80GB HBM3" matches ``h100``: 989e12, the bf16 dense tensor-core peak,
which is used for every dtype as in JAX, so an fp32 step's MFU is
measured against the bf16 peak). Where JAX sums ``jax.live_arrays()``,
the port reads the allocator: ``live_array_bytes`` is its active bytes
(``active_bytes.all.current``) and ``live_array_count`` its active block
count (``active.all.current``), both 0 on the CPU. The peak is one
card's: a port process trains on one card. The analytic FLOP counts are
JAX's.
"""
from __future__ import annotations

import os
import threading
import time

from .registry import (
    TOKEN_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    get_registry,
)

# bf16 peak FLOPs per chip by device-kind substring (first match wins).
# Sources: public TPU/GPU spec sheets; override via peak_flops= or the
# PADDLE_TPU_PEAK_FLOPS env var when the table is wrong for your part.
PEAK_FLOPS_BY_KIND = (
    ("v6e", 918e12),
    ("v5p", 459e12),
    ("v5e", 197e12),
    ("v5 lite", 197e12),
    ("v4", 275e12),
    ("v3", 123e12),
    ("v2", 45e12),
    ("h100", 989e12),
    ("a100", 312e12),
)


def peak_flops_per_device(device=None):
    """Per-device peak FLOPs: env override, else device-kind table,
    else None (unknown part / CPU)."""
    env = os.environ.get("PADDLE_TPU_PEAK_FLOPS")
    if env:
        return float(env)
    try:
        import torch

        if not torch.cuda.is_available():
            return None
        kind = torch.cuda.get_device_name(device).lower()
    except Exception:
        return None
    for sub, peak in PEAK_FLOPS_BY_KIND:
        if sub in kind:
            return peak
    return None


def analytic_param_count(config):
    """Parameter count from a Llama-family config (duck-typed on the
    fields ``LlamaConfig`` carries; GQA-aware)."""
    h = int(config.hidden_size)
    L = int(config.num_hidden_layers)
    inter = int(getattr(config, "intermediate_size", 4 * h))
    vocab = int(getattr(config, "vocab_size", 0))
    nh = int(getattr(config, "num_attention_heads", 1))
    kvh = int(getattr(config, "num_key_value_heads", None) or nh)
    d = h // max(nh, 1)
    attn = h * (nh * d) + 2 * h * (kvh * d) + (nh * d) * h
    mlp = 3 * h * inter  # gate + up + down (SwiGLU)
    norms = 2 * h
    per_layer = attn + mlp + norms
    embed = vocab * h
    head = 0 if getattr(config, "tie_word_embeddings", False) else vocab * h
    return L * per_layer + embed + head + h  # final norm


def analytic_flops_per_token(config, seq_len=None, include_backward=True):
    """Analytic training FLOPs per token (PaLM-style accounting):
    ``2 * N_matmul`` forward per token plus the attention score/value
    term ``4 * s * h * L``; backward ~2x forward, so training = 3x.
    Embedding lookups are excluded (gathers, not matmuls); the LM head
    matmul is included."""
    h = int(config.hidden_size)
    L = int(config.num_hidden_layers)
    vocab = int(getattr(config, "vocab_size", 0))
    n_matmul = analytic_param_count(config) - vocab * h  # drop embed gather
    if getattr(config, "tie_word_embeddings", False):
        # tied configs carry no separate head PARAMETER, but the shared
        # matrix still executes as the LM-head matmul every token
        n_matmul += vocab * h
    fwd = 2 * n_matmul
    if seq_len:
        fwd += 4 * int(seq_len) * h * L
    return fwd * (3 if include_backward else 1)


def device_memory_stats():
    """Host-side memory readout from the CUDA caching allocator: per
    card its bytes in use, peak and total memory, and (the counterpart
    of JAX's ``jax.live_arrays()`` aggregate) the active bytes and
    active block count of the current card. Empty on the CPU."""
    import torch

    out = {"devices": [], "live_array_bytes": 0, "live_array_count": 0}
    try:
        if not torch.cuda.is_available():
            return out
        stats = torch.cuda.memory_stats()
        out["live_array_bytes"] = int(
            stats.get("active_bytes.all.current", 0))
        out["live_array_count"] = int(stats.get("active.all.current", 0))
        for i in range(torch.cuda.device_count()):
            st = torch.cuda.memory_stats(i)
            if not st:
                continue
            out["devices"].append({
                "device": f"cuda:{i}",
                "bytes_in_use": int(st.get("allocated_bytes.all.current",
                                           0)),
                "peak_bytes_in_use": int(
                    st.get("allocated_bytes.all.peak", 0)),
                "bytes_limit": int(
                    torch.cuda.get_device_properties(i).total_memory),
            })
    except Exception:
        pass
    return out


def _is_integer_dtype(dt):
    """True for an integer dtype (torch or numpy), bool excluded as in
    numpy's ``np.integer``."""
    if hasattr(dt, "is_floating_point"):  # a torch dtype
        import torch

        return not (dt.is_floating_point or dt.is_complex
                    or dt == torch.bool)
    import numpy as np

    return bool(np.issubdtype(np.dtype(dt), np.integer))


def batch_geometry(arrays):
    """(examples, tokens) from a step's input arrays: examples = leading
    dim of the first array; tokens counted only for an integer-dtype
    [B, S] input (token ids) — image/audio batches report 0 tokens."""
    for a in arrays:
        shape = getattr(a, "shape", None)
        if not shape:
            continue
        examples = int(shape[0])
        tokens = 0
        dt = getattr(a, "dtype", None)
        if len(shape) == 2 and dt is not None and _is_integer_dtype(dt):
            tokens = int(shape[0]) * int(shape[1])
        return examples, tokens
    return 0, 0


class StepMeter:
    """Per-step training telemetry publishing into the registry.

    Construct with a model/config (or explicit ``flops_per_token``) to
    enable the MFU estimate; without one, MFU stays unreported rather
    than wrong. All instruments register with replace semantics under
    ``paddle_training_*`` / ``paddle_device_*`` names.
    """

    def __init__(self, registry=None, *, recorder=None, model=None,
                 config=None, flops_per_token=None, peak_flops=None,
                 seq_len=None, memory_every=10,
                 namespace="paddle_training"):
        reg = registry or get_registry()
        self.registry = reg
        self._recorder = recorder
        self._lock = threading.Lock()
        self._memory_every = max(1, int(memory_every))
        ns = namespace
        self.step_time = Histogram(
            "step_time", unit="s", prom_name=f"{ns}_step_time_seconds",
            help="wall time of one optimizer step",
        )
        self.compile_time = Histogram(
            "compile_time", unit="s", buckets=(
                0.1, 0.5, 1.0, 5.0, 15.0, 60.0, 300.0, 1800.0,
            ),
            prom_name=f"{ns}_compile_time_seconds",
            help="wall time of warmup steps (the first call: kernel "
                 "builds and allocator growth) — kept OUT of step_time "
                 "so the running mean/throughput stay honest",
        )
        self.steps = Counter(
            "steps", prom_name=f"{ns}_steps_total",
            help="optimizer steps taken",
        )
        self.examples = Counter(
            "examples", prom_name=f"{ns}_examples_total",
            help="training examples consumed",
        )
        self.tokens = Counter(
            "tokens", prom_name=f"{ns}_tokens_total",
            help="training tokens consumed (integer [B,S] inputs only)",
        )
        self.tokens_per_second = Gauge(
            "tokens_per_second", prom_name=f"{ns}_tokens_per_second",
            help="throughput of the most recent step",
        )
        self.examples_per_second = Gauge(
            "examples_per_second", prom_name=f"{ns}_examples_per_second",
            help="throughput of the most recent step",
        )
        self.mfu = Gauge(
            "mfu", prom_name=f"{ns}_mfu",
            help="model FLOPs utilization (analytic estimate, 0..1)",
        )
        self.loss = Gauge(
            "loss", prom_name=f"{ns}_loss",
            help="most recent step loss (lazy: fetched on scrape)",
        )
        self.grad_norm = Gauge(
            "grad_norm", prom_name=f"{ns}_grad_norm",
            help="most recent global gradient norm (when available)",
        )
        self.batch_tokens = Histogram(
            "batch_tokens", unit="tokens", buckets=TOKEN_BUCKETS,
            prom_name=f"{ns}_batch_tokens",
            help="tokens per step",
        )
        self.run_breaks = Counter(
            "run_breaks", prom_name=f"{ns}_run_breaks_total",
            help="dispatch gaps past MAX_STEP_GAP_S, by cause: "
                 "checkpoint_stall (writer backpressure / emergency "
                 "save reported via note_blocked), watchdog_fire (a "
                 "train watchdog flagged the step wedged), unknown "
                 "(eval phase, operator pause, or a genuine hang "
                 "nothing instrumented)",
        )
        self.fp8_bytes_saved = Gauge(
            "amp_fp8_matmul_bytes_saved", unit="bytes",
            prom_name=f"{ns}_amp_fp8_matmul_bytes_saved",
            help="analytic HBM bytes per step the AMP O3 fp8 matmul "
                 "routing avoids moving (weight operands at 1 byte "
                 "instead of their stored width); 0 when O3 is off",
        )
        self.device_bytes_in_use = Gauge(
            "device_bytes_in_use", unit="bytes",
            prom_name="paddle_device_bytes_in_use",
            help="device memory in use (allocator stats; 'aggregate' "
                 "= the allocator's active bytes)",
        )
        self.device_peak_bytes = Gauge(
            "device_peak_bytes_in_use", unit="bytes",
            prom_name="paddle_device_peak_bytes_in_use",
            help="peak device memory (backend stats where available)",
        )
        self.device_live_arrays = Gauge(
            "device_live_arrays",
            prom_name="paddle_device_live_arrays",
            help="the CUDA caching allocator's active block count",
        )
        reg.register_all([
            self.step_time, self.compile_time, self.steps,
            self.examples, self.tokens,
            self.tokens_per_second, self.examples_per_second, self.mfu,
            self.loss, self.grad_norm, self.batch_tokens,
            self.run_breaks, self.fp8_bytes_saved,
            self.device_bytes_in_use, self.device_peak_bytes,
            self.device_live_arrays,
        ])
        self._flops_per_token = flops_per_token
        self._seq_len = seq_len
        self._peak_flops = peak_flops
        self._peak_total = None
        self._mem_high_water = 0
        self._last_step_t = None
        self._blocked_pending = 0.0
        self._wedge_pending = False
        self._blocked_listeners = []
        cfg = getattr(model, "config", None) or config
        if self._flops_per_token is None and cfg is not None and \
                hasattr(cfg, "hidden_size"):
            self._flops_per_token = analytic_flops_per_token(
                cfg, seq_len=seq_len
            )

    # ------------------------------------------------------------- config
    def auto_configure(self, network):
        """Derive flops_per_token from a network's config once (no-op
        when already configured or the network has no model config)."""
        if self._flops_per_token is not None:
            return
        cfg = getattr(network, "config", None)
        if cfg is not None and hasattr(cfg, "hidden_size") and \
                hasattr(cfg, "num_hidden_layers"):
            self._flops_per_token = analytic_flops_per_token(cfg)

    def _peak(self):
        if self._peak_total is None:
            per_dev = self._peak_flops
            if per_dev is None:
                per_dev = peak_flops_per_device()
            if per_dev is None:
                self._peak_total = 0.0
            else:
                self._peak_total = float(per_dev)
        return self._peak_total

    @property
    def recorder(self):
        """Explicit recorder if one was injected, else whatever the
        CURRENT process default is — resolved per use, never cached, so
        a later ``set_flight_recorder()`` starts receiving records
        immediately instead of feeding a stale black box."""
        if self._recorder is not None:
            return self._recorder
        from .flight_recorder import get_flight_recorder

        return get_flight_recorder()

    # -------------------------------------------------------------- steps
    # idle gaps beyond this are a run break (eval phase, user pause),
    # not a slow step — fall back to the caller's host measurement
    MAX_STEP_GAP_S = 60.0

    def note_fp8_bytes_saved(self, n):
        """AMP O3 reports the analytic per-step weight-HBM delta of the
        fp8 matmul routing here (a static trace-time number — no device
        sync)."""
        self.fp8_bytes_saved.set(float(n))

    def note_blocked(self, seconds):
        """Report a train-loop stall that is NOT step work — checkpoint
        writer backpressure, an emergency synchronous save. The stall is
        subtracted from the next dispatch-to-dispatch interval so
        step_time / tokens-per-sec / MFU are not silently deflated by
        save stalls (the caller publishes the stall itself, e.g. into
        ``paddle_ckpt_blocked_seconds``). Attached blocked-listeners
        (the training watchdog's wedge detector) see the same stall so
        they can exclude it from their own gap accounting."""
        with self._lock:
            self._blocked_pending += float(seconds)
            listeners = list(self._blocked_listeners)
        for fn in listeners:
            try:
                fn(seconds)
            except Exception:
                pass

    def add_blocked_listener(self, fn):
        """Forward every ``note_blocked`` stall to ``fn(seconds)`` too
        (the train watchdog registers here, so checkpoint-blocked time
        never reads as a wedged step). Returns an ``undo()``."""
        with self._lock:
            self._blocked_listeners.append(fn)

        def undo():
            with self._lock:
                if fn in self._blocked_listeners:
                    self._blocked_listeners.remove(fn)

        return undo

    def note_wedged(self):
        """A watchdog flagged the CURRENT gap as a wedged step: the
        next run break is attributed to ``watchdog_fire`` instead of
        ``unknown`` in ``paddle_training_run_breaks_total``."""
        with self._lock:
            self._wedge_pending = True

    def observe_step(self, step_time, *, examples=0, tokens=0, loss=None,
                     grad_norm=None, warmup=False):
        """Record one optimizer step. ``loss``/``grad_norm`` may be
        device scalars — they are held as lazy gauge values and only
        fetched when a scrape or crash dump materializes them.

        ``step_time`` is the caller's measurement. A host clock that
        stops at the step's last launch is far below the true step wall
        time on a card (the launches return before the work runs), so
        the port's trainer passes the step's time between two CUDA
        events instead, once the second has completed. From the second
        step on, the meter uses the observe-to-observe interval when it
        is longer: in steady state it converges to true wall-per-step —
        including input-pipeline time, which is what tokens/sec and MFU
        should honestly reflect. Gaps longer than ``MAX_STEP_GAP_S``
        are treated as a run break and fall back to the caller's
        measurement.

        ``warmup=True`` marks a step whose wall time included one-time
        work (the trainer's first call: kernel builds): its time lands
        in the ``compile_time`` histogram and the throughput/MFU gauges
        are left alone, so one compile never poisons ``step_time``'s
        exact running sum/mean."""
        step_time = float(step_time)
        now = time.perf_counter()
        with self._lock:
            last, self._last_step_t = self._last_step_t, now
            blocked, self._blocked_pending = self._blocked_pending, 0.0
            wedged, self._wedge_pending = self._wedge_pending, False
        broke = False
        if not warmup and last is not None:
            # checkpoint (and similar) stalls are excluded: they are
            # real wall time but not step work, and would otherwise
            # deflate throughput between checkpoints
            interval = now - last - blocked
            if step_time <= interval <= self.MAX_STEP_GAP_S:
                step_time = interval
            elif interval > self.MAX_STEP_GAP_S:
                # run break: the dispatch-only host dt is wrong-LOW on
                # accelerators — publishing it would spike the
                # throughput/MFU gauges and pollute the histogram's
                # running mean, so this step only counts volume.
                # Attribution makes the exposition actionable: a stall
                # note_blocked reported is a checkpoint stall, a
                # watchdog flag is a wedged step, anything else is an
                # eval/pause/genuine hang.
                broke = True
                if wedged:
                    reason = "watchdog_fire"
                elif blocked > 0:
                    reason = "checkpoint_stall"
                else:
                    reason = "unknown"
                self.run_breaks.inc(reason=reason)
        self.steps.inc()
        if warmup:
            self.compile_time.observe(step_time)
        elif not broke:
            self.step_time.observe(step_time)
        mfu = None
        if examples:
            self.examples.inc(int(examples))
        if tokens:
            self.tokens.inc(int(tokens))
            self.batch_tokens.observe(tokens)
        if step_time > 0 and not warmup and not broke:
            if examples:
                self.examples_per_second.set(examples / step_time)
            if tokens:
                self.tokens_per_second.set(tokens / step_time)
                peak = self._peak()
                if peak and self._flops_per_token:
                    mfu = (tokens * self._flops_per_token / step_time) \
                        / peak
                    self.mfu.set(mfu)
        if loss is not None:
            self.loss.set(loss)  # lazy: materialized on scrape
        if grad_norm is not None:
            self.grad_norm.set(grad_norm)
        n = self.steps.value
        mem = None
        if n == 1 or n % self._memory_every == 0:
            mem = self.sample_memory()
        rec = {
            "step": n,
            "time": time.time(),
            "warmup": bool(warmup),
            "step_time_s": step_time,
            "examples": int(examples),
            "tokens": int(tokens),
            "tokens_per_s": (tokens / step_time)
            if (tokens and step_time > 0) else None,
            "mfu": mfu,
            "loss": loss,
            "grad_norm": grad_norm,
            "bytes_in_use": mem,
            "mem_high_water": self._mem_high_water,
        }
        try:
            self.recorder.record_step(rec)
        except Exception:
            pass
        return rec

    # ------------------------------------------------------------- memory
    def sample_memory(self):
        """Publish device-memory gauges; returns the aggregate byte
        count used for the flight recorder's high-water mark."""
        try:
            stats = device_memory_stats()
        except Exception:
            return None
        agg = stats["live_array_bytes"]
        self.device_bytes_in_use.set(agg, device="aggregate")
        self.device_live_arrays.set(stats["live_array_count"])
        for d in stats["devices"]:
            self.device_bytes_in_use.set(
                d["bytes_in_use"], device=d["device"]
            )
            self.device_peak_bytes.set(
                d["peak_bytes_in_use"], device=d["device"]
            )
            agg = max(agg, d["bytes_in_use"])
        with self._lock:
            if agg > self._mem_high_water:
                self._mem_high_water = agg
        return agg


# ------------------------------------------------------- process default
_DEFAULT = [None]
_DEFAULT_LOCK = threading.Lock()


def get_step_meter() -> StepMeter:
    """The process-default StepMeter (created lazily; the compiled
    trainer and hapi publish through it unless given another)."""
    with _DEFAULT_LOCK:
        if _DEFAULT[0] is None:
            _DEFAULT[0] = StepMeter()
        return _DEFAULT[0]


def set_step_meter(meter):
    """Install ``meter`` as the process default (pass a configured one
    to enable MFU); returns the previous default."""
    with _DEFAULT_LOCK:
        prev, _DEFAULT[0] = _DEFAULT[0], meter
    return prev


def configure_training(**kw):
    """Build + install a configured process-default StepMeter
    (``model=``/``config=``/``flops_per_token=``/``peak_flops=``...)."""
    meter = StepMeter(**kw)
    set_step_meter(meter)
    return meter
