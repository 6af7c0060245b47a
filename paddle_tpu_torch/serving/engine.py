"""Continuous-batching LLM serving engine over a KV slab (counterpart of
the core of ``paddle_tpu/serving/engine.py`` ``ServingEngine``).

The device runs one fixed-shape decode step over a resident KV state,
and all request lifecycle work (admission, retirement, deadlines,
metrics) happens on the host between steps:

- **prefill**: a prompt, right-padded to its power-of-two bucket, runs
  through a pooled ``[1, bucket]`` cache block and emits the first
  token (the padding only writes slots that decode overwrites before the
  position mask exposes them);
- **adopt**: the block is copied into the request's row of the decode
  slab (in place);
- **decode step**: ``[max_batch]`` tokens at per-row positions -> next
  tokens; free rows ride along as masked garbage.

Each of the three is a fixed-shape program (``programs.py``), as the
JAX engine jits them: one decode step, and a prefill and an adopt per
bucket. On a card each is captured once as a CUDA graph and replayed;
on the CPU the same bodies run as plain calls. ``warmup()`` captures the
whole inventory before traffic; without it a program is captured at its
first use. ``compile_counts()`` counts the captures under the JAX trace
guard's keys. ``graphs=False`` runs every step eagerly instead (the
counterpart of ``jax.disable_jit``), the reference the programs are held
against. Sampling runs outside the programs, on the decode step's
logits.

Greedy token streams equal ``generate`` on the same net and cache dtype.
The paged engine adds the prefix cache and its spill tier on top
(``paged_engine.py``). ``speculative=`` (a
:class:`~.speculative.SpeculativeDecoder`) replaces the decode step by
one propose-and-verify round per row, through the three backend seams
below (``_spec_reserve``, ``_spec_verify``, ``_spec_rollback``);
``warmup()`` then also captures its programs. ``sessions=`` keeps a
:class:`~.sessions.SessionStore`: ``submit(session_id=)`` touches it and
a finished turn records its tokens there. Beam search is
``generate(num_beams=)``'s (``models/generation.py``).
``memory_report()`` is the table of what each program's capture took.

Live reload (``reload.py``): ``prepare_reload`` verifies, loads and
validates a committed checkpoint off the step loop, ``commit_reload``
hands it to the loop, which pauses admission and applies the swap at the
first step with nothing in flight (``reload_weights`` does both). The
swap copies the new weights into the net's parameter and buffer storage,
so the captured programs keep their addresses and are not captured
again; ``weights_version``, ``generation`` and ``last_reload_step``
move, and ``_on_weights_swapped`` fires (the paged engine flushes its
prefix cache there, and speculation forgets its draft caches).

Observability, as the JAX engine wires it: the metrics register in the
process registry (``metrics.py``), with per-SLO-class TTFT, ITL and E2E
children bound once at admission; a request the front end traced
(``handle.trace``) gets an ``engine.queue_wait`` span, an
``engine.prefill`` span and one open ``engine.decode`` span whose
bounded ring takes one ``decode_step`` event a step (a sampled-out
request allocates nothing: the step loop checks one integer); every
capture is recorded in the engine's ``trace_guard`` (a
``recompile-storm`` past ``recompile_guard_max`` distinct signatures of
one program counts in ``metrics.guard_fires``); a reload records an
``engine.reload_pause`` trace and a ``weights_reload`` flight note; and
``memory_report()`` publishes ``paddle_serving_program_peak_bytes`` by
program.

The constructor and ``submit`` take the JAX engine's parameters in its
order, then ``graphs``.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from ..models.generation import (
    DEFAULT_CACHE_DTYPE,
    _select_next,
    decode_step,
    prefill,
)
from ..analysis.trace_guard import TraceGuard
from ..observability import get_flight_recorder, get_registry
from ..observability.tracing import get_tracer
from ..quantization.kv import adopt_into_slab, slab_row_block
from .kv_pool import KVCachePool
from .metrics import ServingMetrics
from .programs import BASE_KINDS, SPEC_KINDS, TRACE_KEYS, Programs
from .sampling_keys import SamplingKeySource
from .scheduler import (
    CANCELLED,
    DONE,
    REASON_ENGINE_CLOSED,
    REASON_TIMEOUT,
    REASON_TOO_LONG,
    REJECTED,
    RUNNING,
    TIMEOUT,
    RejectedError,
    Request,
    RequestHandle,
    Scheduler,
)
from .sessions import SessionStore


def prefill_program(net, caches, bucket, device):
    """The bucketed prefill every prefill site runs (JAX
    ``build_prefill_body``, ``engine.py:75``): ids ``[1, bucket]`` through
    ``net`` over the block ``caches``, written in place -> logits ``[1,
    bucket, V]``. The engines' per-bucket programs and the fleet's
    :class:`~.fleet.kv_transfer.PrefillWorker` capture this same body,
    which is what makes a remote prefill's block and first token
    bit-identical to a local one. Returns ``(body, [ids])``."""
    ids = torch.zeros((1, int(bucket)), dtype=torch.int64, device=device)

    def body(ids):
        return net(ids, caches=caches, pos=0)[0]

    return body, [ids]


class _Seq:
    """Host-side state of one running sequence (one decode row)."""

    __slots__ = ("handle", "last_tok", "emitted", "key", "slo_itl",
                 "slo_e2e")

    def __init__(self, handle, first_tok, key=None, slo_itl=None,
                 slo_e2e=None):
        self.handle = handle
        self.last_tok = first_tok
        self.emitted = 0
        self.key = key  # the request's sampling key (sampling_keys)
        # the request's SLO-class histogram children, bound at admission:
        # the per-token path resolves no label
        self.slo_itl = slo_itl
        self.slo_e2e = slo_e2e

    @property
    def pos(self):
        # cache position of the token fed next step: the last emitted
        # token sits at prompt_len + emitted - 1
        return self.handle.request.prompt_len + self.emitted - 1


class ServingEngine:
    """Continuous batching over a Llama-family causal LM.

    ``max_batch_size`` rows of ``max_seq_len`` slots each; the engine
    runs on the net's device. Greedy by default; ``do_sample=True``
    samples with temperature/top_k/top_p from position-addressed keys
    (``sampling_keys``), so streams reproduce per ``seed``. ``graphs``
    (default True) runs the steps as fixed-shape programs, CUDA graphs
    on a card; False runs them eagerly. ``weights_version`` (default
    ``"v0"``) names the weights the engine serves. ``speculative`` (a
    :class:`~.speculative.SpeculativeDecoder`) is bound here and decodes
    every row by propose-and-verify rounds. ``scheduler``, ``metrics``
    and ``pool`` pass built ones in; ``sessions`` is True (a
    :class:`~.sessions.SessionStore` on the engine's clock), a built
    store, or None. ``reload_template`` is the default ``template_net``
    of :meth:`prepare_reload`. ``recompile_guard_max`` is the trace
    guard's storm bar (JAX's default: ``max(4, buckets + 2)`` from the
    pool's geometry, widened by the prefix cache and speculation)."""

    # the paged engine verifies by replaying its decode step over the
    # arena; the slab engine over a gathered block (``_spec_verify``)
    _spec_verify_in_arena = False

    def __init__(self, net, *, max_batch_size=8, max_seq_len=256,
                 cache_dtype=None, do_sample=False, temperature=1.0,
                 top_k=0, top_p=1.0, seed=0, min_bucket=16,
                 max_queue_size=64, max_tokens_in_flight=None,
                 scheduler=None, metrics=None, pool=None,
                 clock=time.monotonic, recompile_guard_max=None,
                 weights_version=None, reload_template=None,
                 speculative=None, sessions=None, graphs=True):
        self.net = net.eval()
        self.config = net.config
        self.device = net.device
        self.max_batch_size = int(max_batch_size)
        self.max_seq_len = int(max_seq_len)
        self.clock = clock
        self.do_sample = bool(do_sample)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p) if top_p is not None else 1.0
        self.max_tokens_in_flight = max_tokens_in_flight
        self.graphs = bool(graphs)
        self.weights_version = ("v0" if weights_version is None
                                else str(weights_version))
        self._reload_template = reload_template
        self._pending_swap = None
        self.reload_in_progress = False
        self.generation = 0
        self.last_reload_step = None
        if pool is None:
            pool = KVCachePool(
                self.config, dtype=cache_dtype or DEFAULT_CACHE_DTYPE,
                min_bucket=min_bucket, max_seq_len=self.max_seq_len,
                device=self.device,
            )
        self.pool = pool
        self.cache_dtype = self.pool.dtype
        self.scheduler = (Scheduler(max_queue_size=max_queue_size,
                                    clock=clock)
                          if scheduler is None else scheduler)
        self.metrics = ServingMetrics() if metrics is None else metrics
        if sessions is True:
            sessions = SessionStore(clock=clock)
        # None or False: no store (an empty store is falsy: len() 0)
        self.sessions = None if sessions in (None, False) else sessions
        self.keys = SamplingKeySource(seed)
        self._seqs = [None] * self.max_batch_size
        self.step_count = 0
        self._closed = False
        # in-flight requests that carry an open decode span: the decode
        # step checks this one integer and, when zero, allocates nothing
        self._traced_live = 0
        self.speculative = speculative
        self._init_kv_backend()
        if recompile_guard_max is None:
            # one prefill and one adopt per power-of-two bucket of the
            # POOL's geometry, one decode step (``engine.py:257-275``)
            pool_min = getattr(self.pool, "min_bucket", min_bucket)
            pool_max = getattr(self.pool, "max_seq_len", None) \
                or self.max_seq_len
            buckets = 1 + max(
                0, int(math.log2(max(pool_max, 1)))
                - int(math.log2(max(pool_min, 1)))
            )
            recompile_guard_max = max(4, buckets + 2)
        self.trace_guard = TraceGuard(max_compiles=recompile_guard_max)
        self.trace_guard.on_fire(self._on_guard_fire)
        self._programs = Programs(self.device, self._program_kinds(),
                                  guard=self.trace_guard)
        self._net_key = None
        if speculative is not None:
            speculative.bind(self)

    def _on_guard_fire(self, finding):
        """A capture storm at run time: counted by program on the
        engine's metrics (JAX also emits a profiler span, which waits
        with ``ROADMAP.md`` queue A item 7)."""
        self.metrics.guard_fires.inc(label=finding.graph)

    # ------------------------------------------------------- KV backend
    def _init_kv_backend(self):
        """The resident decode KV state: a slab of ``max_batch_size``
        rows (the paged engine overrides with a page arena)."""
        self._caches = self.pool.alloc_slab_arrays(self.max_batch_size,
                                                   self.max_seq_len)
        self._slab = self.pool.register_slab(self.max_batch_size,
                                             self.max_seq_len)

    def _has_capacity(self):
        return self._slab.free_slots > 0

    def _claim_row(self, req):
        return self._slab.claim()

    def _release_slot(self, slot):
        if self.speculative is not None:
            self.speculative.reset_slot(slot)
        self._slab.release(slot)

    def _adopt_body(self, blk):
        """Copy the prefilled block into the decode row ``row`` (the
        adopt program's one-element tensor), in place."""
        caches = self._caches

        def body(row):
            for (dk, dv), (bk, bv) in zip(caches, blk.caches):
                adopt_into_slab(dk, bk, row)
                adopt_into_slab(dv, bv, row)
            return ()
        return body

    def _adopt_zeros(self, blk):
        """Zeros of the adopt program's input (the warm run's)."""
        return np.zeros((1,), np.int64)

    def _run_adopt(self, blk, index):
        """Adopt ``blk`` at ``index`` (the adopt program's input, numpy:
        the slab row, or the paged engine's page ids), through the
        program or, with ``graphs=False``, its body."""
        with torch.inference_mode():
            if self.graphs:
                self._programs.run(("adopt", blk.bucket),
                                   lambda: self._build_adopt(blk), index)
            else:
                self._adopt_body(blk)(
                    torch.from_numpy(index).to(self.device))

    def _decode_table(self):
        """The decode step's page table (host; the paged engine's), None
        without one."""
        return None

    def _decode_extra(self):
        """Extra keyword inputs of the eager decode step."""
        table = self._decode_table()
        return ({} if table is None else
                {"page_table": torch.from_numpy(table).to(self.device)})

    def _decode_arrays(self, tok, pos):
        """The decode program's host inputs."""
        table = self._decode_table()
        return (tok, pos) if table is None else (tok, pos, table)

    # ------------------------------------- speculative backend seams
    #
    # speculative.SpeculativeDecoder drives its verify through these
    # three hooks. On the slab every row owns its whole span, so reserve
    # always succeeds and rollback is free (the rejected tail's KV sits
    # behind the position mask until the row overwrites it); the paged
    # engine overrides them with demand-claimed pages and a verify over
    # the arena.

    def _spec_reserve(self, slot, hi):
        """Hold KV capacity for verify writes up to position ``hi``;
        returns the highest position held (clamped below ``hi`` when the
        backend cannot cover it)."""
        return min(hi, self.max_seq_len - 1)

    def _spec_verify(self, slot, ids, pos):
        """Score ``ids`` (``[1, k1]``) at positions ``[pos, pos + k1)``
        of row ``slot`` and write their KV there: the row gathered into
        the full-width pooled block (the ``spec_gather`` program, the slot
        a device input), the verify program over it (the JAX chunk-write
        and broadcast re-read: a slab row cannot read another row's
        writes), and the block adopted back through the adopt program
        admission uses. Returns the logits ``[k1, V]``, valid until the
        next call of the same verify program."""
        spec = self.speculative
        k1 = int(ids.shape[1])
        blk = self.pool.alloc(self.max_seq_len)
        try:
            with torch.inference_mode():
                self._run_program(("spec_gather",),
                                  lambda: self._build_spec_gather(blk),
                                  np.array([slot], np.int64))
                logits = self._run_program(
                    ("spec_verify", blk.bucket, k1),
                    lambda: spec._build_verify(blk, k1), ids,
                    np.array([pos], np.int32))
            self._run_adopt(blk, np.array([slot], np.int64))
        finally:
            self.pool.free(blk)
        return logits

    def _build_spec_gather(self, blk):
        caches = self._caches
        inputs = [torch.zeros((1,), dtype=torch.int64, device=self.device)]

        def body(slot):
            for (sk, sv), (bk, bv) in zip(caches, blk.caches):
                slab_row_block(sk, slot, bk)
                slab_row_block(sv, slot, bv)
            return ()
        return body, inputs, (caches, blk.caches)

    def _spec_rollback(self, slot, new_pos):
        """Drop verify writes past the accepted span (the row's next token
        feeds at ``new_pos``): free on the slab."""

    def _warm_spec_verify(self, spec, buckets):
        """Capture the verify's programs: a verify per k1 in ``1..k+1``
        over the full-width block, the gather before it and the
        full-width adopt after it. Returns how many were captured."""
        blk = self.pool.alloc(self.max_seq_len)
        try:
            n = sum(self._programs.warm(
                        ("spec_verify", blk.bucket, k1),
                        lambda: spec._build_verify(blk, k1),
                        np.zeros((1, k1), np.int64),
                        np.zeros((1,), np.int32))
                    for k1 in range(1, spec.k + 2))
            return (n + self._programs.warm(
                        ("spec_gather",), lambda: self._build_spec_gather(blk),
                        np.zeros((1,), np.int64))
                    + self._programs.warm(
                        ("adopt", blk.bucket), lambda: self._build_adopt(blk),
                        self._adopt_zeros(blk)))
        finally:
            self.pool.free(blk)

    # ------------------------------------------------------- programs
    def _program_kinds(self):
        """The program kinds this engine captures (and counts)."""
        if self.speculative is None:
            return BASE_KINDS
        return BASE_KINDS + ("spec_gather",) + SPEC_KINDS

    def _run_program(self, key, build, *arrays):
        """Call the program ``key`` on ``arrays`` (numpy) or, with
        ``graphs=False``, run its body eagerly on device copies of them;
        the caller holds ``inference_mode``."""
        if self.graphs:
            self._check_net()
            return self._programs.run(key, build, *arrays)
        body, inputs, _ = build()
        for t, a in zip(inputs, arrays):
            t.copy_(torch.from_numpy(np.ascontiguousarray(a)))
        return body(*inputs)

    def _check_net(self):
        """A change of ``net.fusions`` (or of ``net.training``) on a live
        engine makes the programs that run the model, captured without
        it, stale: they are captured again at their next call."""
        key = (self.net.fusions, self.net.training)
        if key != self._net_key:
            self._programs.drop(("decode", "prefill", "chunk") + SPEC_KINDS)
            self._net_key = key

    def _keep(self):
        """What the model programs read besides their inputs."""
        return (tuple(self.net.state_dict(keep_vars=True).values()),
                self._caches)

    def _build_decode(self):
        b = self.max_batch_size
        table = self._decode_table()
        dev = self.device
        inputs = [torch.zeros((b, 1), dtype=torch.int64, device=dev),
                  torch.zeros((b,), dtype=torch.int32, device=dev)]
        if table is not None:
            inputs.append(torch.zeros(table.shape, dtype=torch.int32,
                                      device=dev))
        net, caches = self.net, self._caches

        def body(tok, pos, page_table=None):
            logits, _ = decode_step(net, tok, caches, pos,
                                    page_table=page_table)
            return logits, torch.argmax(logits, dim=-1)

        return body, inputs, self._keep()

    def _build_prefill(self, blk):
        body, inputs = prefill_program(self.net, blk.caches, blk.bucket,
                                       self.device)
        return body, inputs, (self._keep(), blk.caches)

    def _build_adopt(self, blk):
        index = torch.from_numpy(self._adopt_zeros(blk)).to(self.device)
        return self._adopt_body(blk), [index], (self._caches, blk.caches)

    def compile_counts(self):
        """Captures by program kind, under the JAX trace guard's keys
        (``serving::decode_step``, ``serving::prefill``,
        ``serving::adopt``; a prefix-cache engine adds
        ``serving::gather_pages`` and ``serving::chunk_prefill``; a
        speculative one ``serving::spec_draft_prefill``,
        ``serving::spec_draft_decode`` and ``serving::spec_verify``, and
        on the slab its gather, ``serving::spec_gather``); a program
        captured again after a change of ``net.fusions`` counts again.
        The paged engine captures no verify program: its
        ``serving::spec_verify`` counts the decode replays that served a
        verify."""
        return dict(self._programs.counts)

    def memory_report(self):
        """What each program's capture took, by program name (the JAX
        names: ``decode``, ``prefill_b{b}``, ``chunk_b{b}_t{tb}``, ...):
        ``graph_pool_bytes`` (the growth of ``torch.cuda.memory_reserved()``
        across its first call, the eager run and the capture into the
        engine's graph pool, from an emptied cache), ``peak_bytes`` (the
        most that call allocated above what was allocated when it began)
        and ``static_bytes`` (its static inputs and outputs).
        These are the card's own numbers, where JAX reads XLA's estimates;
        on the CPU every count is 0. None before any capture (``warmup()``
        or a program's first use); otherwise ``{"programs", "max_peak_
        bytes"}``."""
        table = self._programs.memory
        if not table:
            return None
        self._publish_memory_gauges(table)
        return {"programs": dict(table),
                "max_peak_bytes": max(e["peak_bytes"]
                                      for e in table.values())}

    @staticmethod
    def _publish_memory_gauges(table):
        g = get_registry().gauge(
            "paddle_serving_program_peak_bytes",
            help="peak allocated bytes of each serving program's first "
                 "call (its capture)",
            unit="bytes",
        )
        for name, entry in table.items():
            g.set(float(entry["peak_bytes"]), program=name)

    def warmup(self, aot_cache=None, buckets=None):
        """Capture every fixed-shape program before traffic: the decode
        step, and a prefill and an adopt per prompt bucket (``buckets``,
        by default the pool's power-of-two ladder). Each body runs once
        on zero inputs (so the decode step writes only the garbage page
        0 or free slab rows, the prefill only its pooled block, the
        adopt only page 0 or the free row 0), then is captured; programs
        already captured are skipped. A speculative engine then captures
        the speculative inventory (``SpeculativeDecoder.warmup``). Returns
        ``{"programs", "aot_hits", "aot_saves"}`` as the JAX ``warmup``
        does; ``programs`` is 0 with ``graphs=False``. The engine must be
        idle."""
        if self._closed:
            raise RuntimeError(f"{type(self).__name__} is closed")
        if aot_cache is not None:
            raise NotImplementedError(
                "warmup(aot_cache=...): the AOT executable cache is not "
                "ported (ROADMAP.md queue A item 7)")
        stats = {"programs": 0, "aot_hits": 0, "aot_saves": 0}
        if not self.graphs:
            return stats
        if self.active_slots:
            raise RuntimeError(
                "warmup() runs on an idle engine (its warm runs write the "
                "free rows)")
        self._check_net()
        b = self.max_batch_size
        if buckets is None:
            buckets = self._warmup_buckets()
        with torch.inference_mode():
            # an idle engine's page table is all zeros
            warmed = [self._programs.warm(
                ("decode",), self._build_decode, *self._decode_arrays(
                    np.zeros((b, 1), np.int64), np.zeros((b,), np.int32)))]
            for bucket in buckets:
                blk = self.pool.alloc(bucket)
                try:
                    warmed.append(self._programs.warm(
                        ("prefill", blk.bucket),
                        lambda: self._build_prefill(blk),
                        np.zeros((1, blk.bucket), np.int64)))
                    warmed.append(self._programs.warm(
                        ("adopt", blk.bucket),
                        lambda: self._build_adopt(blk),
                        self._adopt_zeros(blk)))
                finally:
                    self.pool.free(blk)
            warmed.append(self._warm_more(buckets))
            if self.speculative is not None:
                warmed.append(self.speculative.warmup(self, buckets))
        stats["programs"] = sum(warmed)
        if self._programs.memory:
            self._publish_memory_gauges(self._programs.memory)
        return stats

    def _warm_more(self, buckets):
        """The programs an engine adds to the base inventory before the
        speculative ones (the paged engine's prefix cache); returns how
        many it captured."""
        return 0

    def _warmup_buckets(self):
        """Every prompt bucket the pool admits (``engine.py:936``):
        ``min_bucket``, doubling, up to ``max_seq_len``."""
        out, n = [], self.pool.min_bucket
        while True:
            b = self.pool.bucket_for(min(n, self.max_seq_len))
            if b not in out:
                out.append(b)
            if n >= self.max_seq_len:
                return out
            n *= 2

    # ---------------------------------------------------------- requests
    def _too_long(self, req):
        return req.total_tokens > self.max_seq_len or (
            self.max_tokens_in_flight is not None
            and req.total_tokens > self.max_tokens_in_flight
        )

    def submit(self, input_ids, max_new_tokens=32, *, eos_token_id=None,
               priority=0, deadline_s=None, slo_class=None,
               session_id=None, on_token=None, on_event=None):
        """Enqueue one request; always returns a RequestHandle (status
        REJECTED with ``.reason`` set on backpressure). ``session_id``
        marks it as one turn of a conversation: the session store is
        touched here and records the finished turn (never changing the
        stream)."""
        req = Request(input_ids, max_new_tokens, eos_token_id=eos_token_id,
                      priority=priority, deadline_s=deadline_s,
                      slo_class=slo_class, session_id=session_id)
        self.metrics.submitted.inc()
        if session_id is not None and self.sessions is not None \
                and not self._closed:
            self.sessions.touch(session_id)
        reason = (REASON_ENGINE_CLOSED if self._closed
                  else REASON_TOO_LONG if self._too_long(req) else None)
        if reason is not None:
            h = RequestHandle(req, on_token=on_token, on_event=on_event)
            h.submit_time = h.finish_time = self.clock()
            h.status = REJECTED
            h.reason = reason
            self.metrics.rejected.inc(label=reason)
            h._fire_terminal()
            return h
        try:
            return self.scheduler.submit(req, on_token=on_token,
                                         on_event=on_event)
        except RejectedError as e:
            self.metrics.rejected.inc(label=e.reason)
            return e.handle

    # --------------------------------------------------------- the loop
    @property
    def active_slots(self):
        return sum(1 for s in self._seqs if s is not None)

    def _tokens_in_flight(self):
        return sum(s.handle.request.total_tokens
                   for s in self._seqs if s is not None)

    def _finish(self, slot, status, reason=None):
        seq = self._seqs[slot]
        h = seq.handle
        now = self.clock()
        h.status = status
        h.reason = reason
        h.finish_time = now
        h.finished_step = self.step_count
        if status == DONE:
            self.metrics.completed.inc()
        elif status == TIMEOUT:
            self.metrics.timeouts.inc()
        tid = None if h.trace is None else h.trace.trace_id
        (seq.slo_e2e or self.metrics.e2e).observe(
            now - h.submit_time, trace_id=tid)
        sp = h._decode_span
        if sp is not None:
            h._decode_span = None
            self._traced_live -= 1
            sp.finish(status=status, tokens=len(h.tokens),
                      **({"error": reason} if reason else {}))
        sid = h.request.session_id
        if sid is not None and self.sessions is not None \
                and not self._closed:
            # the finished turn's whole conversation (prompt and answer):
            # the chain turn N+1's prompt extends
            self.sessions.note_turn(sid, h.output_ids)
        self._seqs[slot] = None
        self._release_slot(slot)
        h._fire_terminal()

    def _append(self, slot, tok):
        seq = self._seqs[slot]
        h = seq.handle
        h.tokens.append(int(tok))
        seq.last_tok = int(tok)
        seq.emitted += 1
        self.metrics.tokens_out.inc()
        h._fire_token(tok)
        req = h.request
        if req.eos_token_id is not None and int(tok) == req.eos_token_id:
            self._finish(slot, DONE)
        elif seq.emitted >= req.max_new_tokens:
            self._finish(slot, DONE)

    def _next_key(self):
        """The admitted request's sampling key (None when greedy)."""
        return self.keys.next_request_key() if self.do_sample else None

    def _prefill(self, req, key):
        """Bucketed prefill of one request -> (first token, block)."""
        bucket = self.pool.bucket_for(req.prompt_len)
        ids = np.zeros((1, bucket), np.int64)
        ids[0, :req.prompt_len] = req.input_ids
        blk = self.pool.alloc(req.prompt_len)
        try:
            with torch.inference_mode():
                if self.graphs:
                    self._check_net()
                    logits = self._programs.run(
                        ("prefill", bucket),
                        lambda: self._build_prefill(blk), ids,
                    )[:, req.prompt_len - 1, :]
                else:
                    logits, blk.caches = prefill(
                        self.net, torch.from_numpy(ids).to(self.device),
                        blk.caches, length=req.prompt_len,
                    )
                # the first sampled token lands at cache position
                # prompt_len (the sampling_keys position address)
                nxt = _select_next(
                    logits, self.do_sample, self.temperature, self.top_k,
                    self.top_p, [(key, req.prompt_len)])
                t0 = int(nxt[0])
        except BaseException:
            self.pool.free(blk)
            raise
        return t0, blk

    def _admit_one(self, handle):
        req = handle.request
        now = self.clock()
        row = self._claim_row(req)
        psp = None if handle.trace is None else get_tracer().start_span(
            "engine.prefill", handle.trace, mode="local",
            bucket=self.pool.bucket_for(req.prompt_len))
        try:
            key = self._next_key()
            t_start = self.clock()
            t0, blk = self._prefill(req, key)
            try:
                self._run_adopt(blk, np.array([row], np.int64))
            finally:
                self.pool.free(blk)
            self.metrics.prefill_time.observe(self.clock() - t_start)
        except BaseException:
            if psp is not None:
                psp.finish(error="admission_error")
            self._release_slot(row)
            raise
        if psp is not None:
            psp.finish()
        self._start_seq(handle, row, t0, key, now)

    def _trace_admitted(self, handle, slot, wait):
        """Admission-time spans under the request's trace context: the
        queue wait rendered retroactively (its duration is the
        ``queue_wait`` histogram's sample), and the one open decode span
        whose bounded event ring the step loop feeds. Nothing when the
        request is sampled out (``handle.trace is None``)."""
        tspan = handle.trace
        if tspan is None:
            return
        tr = get_tracer()
        tr.record_span("engine.queue_wait", tspan, wait)
        handle._decode_span = tr.start_span("engine.decode", tspan,
                                            slot=slot)
        if handle._decode_span is not None:
            self._traced_live += 1

    def _start_seq(self, handle, row, t0, key, now):
        """An admitted request's first token ``t0`` in decode row ``row``:
        its handle, metrics and sequence state."""
        req = handle.request
        handle.status = RUNNING
        handle.weights_version = self.weights_version
        handle.admit_time = now
        handle.admitted_step = self.step_count
        handle.first_token_time = self.clock()
        wait = now - handle.submit_time
        tid = None if handle.trace is None else handle.trace.trace_id
        self.metrics.admitted.inc()
        self.metrics.prefill_tokens.inc(req.prompt_len)
        self.metrics.queue_wait.observe(wait, trace_id=tid)
        slo_ttft, slo_itl, slo_e2e = self.metrics.slo_children(
            req.slo_class)
        slo_ttft.observe(handle.first_token_time - handle.submit_time,
                         trace_id=tid)
        self._trace_admitted(handle, row, wait)
        self._seqs[row] = _Seq(handle, t0, key=key, slo_itl=slo_itl,
                               slo_e2e=slo_e2e)
        self._append(row, t0)

    def _admission_budget(self):
        """Token budget the next admission must fit (None = no cap)."""
        if self.max_tokens_in_flight is None:
            return None
        return self.max_tokens_in_flight - self._tokens_in_flight()

    def _max_admissions_per_step(self):
        """Prefills allowed per engine step (None = unbounded)."""
        return None

    def _admission_fits(self):
        """A per-request admission predicate for the scheduler's pop
        (None: the token budget alone decides; the prefix-cache engine's
        page need depends on the cache)."""
        return None

    def step(self):
        """One engine iteration: retire expired, admit into free rows,
        run one decode step over the whole resident KV state."""
        if self._closed:
            raise RuntimeError(f"{type(self).__name__} is closed")
        # a staged weight swap applies the moment nothing is in flight
        self._maybe_apply_reload()
        now = self.clock()
        for i, seq in enumerate(self._seqs):
            if seq is None:
                continue
            dl = self.scheduler.deadline_of(seq.handle)
            if dl is not None and now > dl:
                self._finish(i, TIMEOUT, reason=REASON_TIMEOUT)
        self.scheduler.sweep_expired()
        cap = self._max_admissions_per_step()
        admitted = 0
        # a pending reload pauses admission: in-flight requests drain on
        # the old weights, queued ones wait for the swap
        while self._pending_swap is None and self._has_capacity() and (
                cap is None or admitted < cap):
            handle = self.scheduler.pop_next(self._admission_budget(),
                                             fits=self._admission_fits())
            if handle is None:
                break
            try:
                self._admit_one(handle)
            except BaseException as e:
                # popped already: resolve it before propagating
                handle.status = REJECTED
                handle.reason = f"admission_error:{type(e).__name__}"
                handle.finish_time = self.clock()
                self.metrics.rejected.inc(label="admission_error")
                handle._fire_terminal()
                raise
            admitted += 1
        for _ in self.scheduler.drain_timed_out():
            self.metrics.timeouts.inc()
        self._decode_once()
        self.step_count += 1
        self.metrics.observe_step(self.scheduler.depth, self.active_slots)

    def _decode_once(self):
        """One decode step over every row (free rows are masked garbage
        whose writes land on slots that adoption overwrites); under
        speculation, one propose-and-verify round per row instead."""
        active = [i for i, s in enumerate(self._seqs) if s is not None]
        if not active:
            return
        if self.speculative is not None:
            t0 = self.clock()
            with torch.inference_mode():
                n = self.speculative.decode_once(self)
            self.metrics.decode_step_time.observe(self.clock() - t0)
            self.metrics.decode_tokens.inc(n)
            return
        tok = np.zeros((self.max_batch_size, 1), np.int64)
        pos = np.zeros((self.max_batch_size,), np.int32)
        keys = [None] * self.max_batch_size
        for i in active:
            seq = self._seqs[i]
            tok[i, 0] = seq.last_tok
            pos[i] = seq.pos
            # the token sampled this step lands at pos + 1
            keys[i] = (seq.key, seq.pos + 1)
        t0 = self.clock()
        with torch.inference_mode():
            if self.graphs:
                self._check_net()
                logits, greedy = self._programs.run(
                    ("decode",), self._build_decode,
                    *self._decode_arrays(tok, pos))
            else:
                logits, self._caches = decode_step(
                    self.net, torch.from_numpy(tok).to(self.device),
                    self._caches, torch.from_numpy(pos).to(self.device),
                    **self._decode_extra(),
                )
                greedy = None
            nxt = (greedy if greedy is not None and not self.do_sample
                   else _select_next(logits, self.do_sample,
                                     self.temperature, self.top_k,
                                     self.top_p, keys)).cpu().numpy()
        dt = self.clock() - t0
        self.metrics.decode_step_time.observe(dt)
        self.metrics.decode_tokens.inc(len(active))
        if self._traced_live:
            # one bounded-ring event per traced request per step; a
            # sampled-out run never reaches this branch
            occ = len(active)
            for i in active:
                sp = self._seqs[i].handle._decode_span
                if sp is not None:
                    sp.event("decode_step", step=self.step_count,
                             occupancy=occ, dt_s=dt)
        for i in active:
            seq = self._seqs[i]
            if seq is None:
                continue  # finished by an earlier row this step
            (seq.slo_itl or self.metrics.itl).observe(dt)
            self._append(i, nxt[i])

    def run_until_idle(self, max_steps=100_000):
        """Drive ``step()`` until queue and rows are empty."""
        steps = 0
        while self.scheduler.depth or self.active_slots:
            if steps >= max_steps:
                raise RuntimeError(
                    f"run_until_idle: not drained after {max_steps} steps "
                    f"(queue={self.scheduler.depth}, "
                    f"active={self.active_slots})"
                )
            self.step()
            steps += 1
        return steps

    def generate(self, prompts, max_new_tokens=32, **submit_kwargs):
        """Submit every prompt, drain, return the handles in order."""
        handles = [self.submit(p, max_new_tokens, **submit_kwargs)
                   for p in prompts]
        self.run_until_idle()
        return handles

    # ------------------------------------------------------- live reload
    def _weights(self):
        """The net's parameters and buffers by name: the storage a swap
        copies into."""
        return (dict(self.net.named_parameters()),
                dict(self.net.named_buffers()))

    def prepare_reload(self, ckpt_dir, *, weights_version=None,
                       template_net=None, verify_level="full"):
        """Stage a weight swap from a committed checkpoint directory (or a
        checkpoint root: the newest committed step wins): verify the
        manifest and CRCs, load into staging tensors on the engine's
        device (or into ``template_net``, quantized for serving when this
        engine serves int8 weights), and validate against the engine's
        parameters and buffers. Pure and thread-safe; pass the result to
        :meth:`commit_reload`. Failures come back as a non-ok
        :class:`~.reload.StagedReload`, counted by outcome, never an
        exception."""
        from .reload import prepare_state_swap

        params, buffers = self._weights()
        staged = prepare_state_swap(
            self.net, params, buffers, ckpt_dir,
            weights_version=weights_version,
            template_net=(self._reload_template if template_net is None
                          else template_net),
            verify_level=verify_level,
        )
        if not staged.ok:
            self.metrics.reloads.inc(label=staged.outcome)
        return staged

    def commit_reload(self, staged):
        """Hand a prepared swap to the step loop (on the engine's thread).
        Applies at once when nothing is in flight; otherwise admission
        pauses and the swap lands at the first step boundary with no
        request running. A swap committed over a still-pending one
        supersedes it."""
        if not staged.ok:
            return staged
        if self._closed:
            staged.ok = False
            staged.outcome = "engine_closed"
            self.metrics.reloads.inc(label="engine_closed")
            return staged
        if self._pending_swap is not None:
            self.metrics.reloads.inc(label="superseded")
            self._pending_swap.outcome = "superseded"
            self._pending_swap.params = self._pending_swap.buffers = None
        staged.staged_at = self.clock()
        self._pending_swap = staged
        self.reload_in_progress = True
        self._maybe_apply_reload()
        return staged

    def reload_weights(self, ckpt_dir, **kw):
        """prepare + commit in one call (callers on the engine's own
        thread)."""
        return self.commit_reload(self.prepare_reload(ckpt_dir, **kw))

    def _maybe_apply_reload(self):
        if self._pending_swap is not None and self.active_slots == 0:
            self._apply_reload()

    def _apply_reload(self):
        from .. import chaos as _chaos
        from .reload import apply_state_swap

        staged = self._pending_swap
        try:
            # the deterministic kill-mid-swap seam: a fault here leaves
            # the engine fully on the old weights (nothing has changed)
            _chaos.poke("reload.apply", step=staged.step,
                        version=staged.weights_version)
        except BaseException as e:
            self._pending_swap = None
            self.reload_in_progress = False
            staged.ok = False
            staged.outcome = "error"
            staged.error = repr(e)
            staged.params = staged.buffers = None
            self.metrics.reloads.inc(label="error")
            return
        params, buffers = self._weights()
        apply_state_swap(staged, params, buffers)
        self.weights_version = staged.weights_version
        self.generation += 1
        self.last_reload_step = staged.step
        self._pending_swap = None
        self.reload_in_progress = False
        self._on_weights_swapped()
        # disaggregation stays exact across the rotation: the transport's
        # version-skew refusal now turns old-weights blocks away
        tr = getattr(self, "prefill_transport", None)
        if tr is not None and getattr(tr, "expected_weights_version",
                                      None) is not None:
            tr.expected_weights_version = staged.weights_version
        if staged.staged_at is not None:
            pause = self.clock() - staged.staged_at
            self.metrics.reload_ttft_spike.observe(pause)
            # the admission pause as a (head-sampled) root span, in the
            # same timeline as the requests it delayed
            get_tracer().record_trace(
                "engine.reload_pause", pause,
                version=staged.weights_version, step=staged.step,
            )
        self.metrics.reloads.inc(label="ok")
        staged.outcome = "applied"
        try:
            get_flight_recorder().note(
                "weights_reload", step=staged.step,
                version=staged.weights_version, path=staged.path,
                generation=self.generation,
            )
        except Exception:
            pass

    def _on_weights_swapped(self):
        """Post-swap hook, with the new weights in place and nothing in
        flight. The paged engine flushes its prefix cache here (and calls
        up); speculation forgets its draft caches."""
        if self.speculative is not None:
            self.speculative.on_weights_swapped(self)

    def close(self):
        """Cancel queued and running requests (partial tokens kept),
        release every row, and drop the KV state; a pending swap is
        abandoned."""
        self._closed = True
        if self._pending_swap is not None:
            self._pending_swap.params = self._pending_swap.buffers = None
            self._pending_swap = None
            self.reload_in_progress = False
            self.metrics.reloads.inc(label="abandoned")
        while True:
            h = self.scheduler.pop_next()
            if h is None:
                break
            h.status = CANCELLED
            h.reason = REASON_ENGINE_CLOSED
            h.finish_time = self.clock()
            h._fire_terminal()
        for i, seq in enumerate(self._seqs):
            if seq is None:
                continue
            h = seq.handle
            h.status = CANCELLED
            h.reason = REASON_ENGINE_CLOSED
            h.finish_time = self.clock()
            h.finished_step = self.step_count
            self._seqs[i] = None
            self._release_slot(i)
            h._fire_terminal()
        self._programs.drop(tuple(TRACE_KEYS))
        if self.speculative is not None:
            self.speculative.unbind()
        if self.sessions is not None:
            self.sessions.close()
        self._caches = None
