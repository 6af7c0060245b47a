"""Speculative decoding: draft-propose, one-launch verify (counterpart of
``paddle_tpu/serving/speculative.py``).

A cheap draft proposes ``k`` tokens one at a time, the target scores all
``k + 1`` positions in one program, and a host-side acceptance rule keeps
the longest valid prefix: every round emits between 1 and ``k + 1``
tokens for one verify launch.

The engine scores the ids ``[last, d_1..d_k]`` at positions ``[pos,
pos + k]`` (its ``_spec_verify`` seam):

- **the paged engine** replays its own decode program with the round's
  positions on its rows, every row over the request's page table: the
  step writes each row's K/V into the arena before the paged kernel
  reads, so row ``i`` reads what rows ``0..i-1`` wrote and its logits
  are the vanilla decode step's row (float and int8 arenas alike);
- **the slab engine** (a slab row cannot read another row's writes)
  runs the verify program of this module over a ``[1, max_seq_len]``
  prefill-layout block of the row, ``pos`` a ``[1]`` device tensor so
  one capture serves every position: **chunk-write** (the ids through
  the cache path, head skipped, writing their K/V into the block), then
  **broadcast re-read** (the block copied to ``k + 1`` rows by
  :func:`~..quantization.kv.broadcast_rows` and one decode step scoring
  row ``i`` at position ``pos + i``). An int8 cache keeps per-token fp32
  scales, so its verify instead unrolls ``k + 1`` decode sub-steps in one
  program, the vanilla data flow. The block then goes back through the
  engine's adopt program.

The paged engine releases the rejected tail's pages after the round.

Greedy acceptance keeps each proposal that equals the target's argmax;
with ``do_sample`` acceptance is the Leviathan/Chen rejection rule over
the same filtered distributions the sampling head uses, each uniform
drawn from the request's position-addressed purpose keys
(``sampling_keys``), so slab and paged engines emit the same sampled
streams; an all-accepted round draws its bonus token as vanilla decode
would draw that position (``sample_rows`` with the position key).

Drafts: a separate small causal LM sharing the target's vocabulary, or
the self-speculative early exit, ``exit_layer=N``: the target's first N
layers and the shared head (the model's ``exit_layer`` seam). The draft
keeps its own cache, a slab ``[max_batch_size, max_seq_len]`` of its
layers: a context is ingested by a draft prefill per bucket (into the
draft's pooled block, then copied into the row), and each proposal is a
draft decode step, one program per engine row (a captured graph reads
fixed addresses, so each row's view of the slab has its own).

Every program is one of the engine's fixed-shape programs
(``programs.py``), CUDA graphs on a card: ``warmup()`` captures draft
prefill per bucket and draft decode per row, and on the slab a verify
per ``k1`` in ``1..k+1`` and the gather. A failing program raises; nothing
falls back to the vanilla decode step. Rounds run one row after another,
which trades batched throughput for latency (the win is at low
concurrency). After a live reload (:meth:`SpeculativeDecoder.
on_weights_swapped`) every row's draft cache is stale; the self-speculative
draft is the target net itself, whose weights the swap wrote in place, so
it follows them with no copy. A traced request's round is an
``engine.verify`` span; the round's ITL lands in the request's SLO-class
child, bound at admission. Not ported: the AOT signature (``ROADMAP.md``
queue A item 7).
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from ..models.generation import decode_step, filter_logits
from ..observability.tracing import get_tracer
from ..quantization.kv import QuantizedKV, adopt_into_slab, broadcast_rows
from ..quantization.kv import is_quantized
from .kv_pool import KVCachePool
from .sampling_keys import (
    ACCEPT,
    DRAFT,
    RESIDUAL,
    purpose_key,
    sample_rows,
    uniform,
)


class _EarlyExitDraft:
    """The self-speculative draft: the target's first ``exit_layer``
    decoder layers, final norm and head, called as a causal LM. Its
    ``config`` is a truncated copy, so its caches hold exactly
    ``exit_layer`` layers."""

    def __init__(self, target, exit_layer):
        n = int(exit_layer)
        if not 1 <= n <= target.config.num_hidden_layers:
            raise ValueError(
                f"exit_layer {exit_layer} outside [1, "
                f"{target.config.num_hidden_layers}]"
            )
        self.target = target
        self.exit_layer = n
        self.config = copy.copy(target.config)
        self.config.num_hidden_layers = n

    def __call__(self, input_ids, attn_mask=None, caches=None, pos=None,
                 page_table=None):
        return self.target(input_ids, attn_mask, caches=caches, pos=pos,
                           page_table=page_table,
                           exit_layer=self.exit_layer)


# ------------------------------------------------------- acceptance math
#
# Host-side numpy: the verify program returns raw logits rows; what
# follows depends only on those rows and the request's keys, so both
# engines compute the same outcomes.


def _dist(row, temperature, top_k, top_p):
    """One logits row ``[V]`` -> normalized float64 probabilities over
    the filtered support the sampling head uses."""
    t = torch.as_tensor(np.asarray(row, np.float32))
    f = filter_logits(t[None, :], temperature, top_k, top_p)[0].numpy()
    f = f - np.max(f)
    p = np.exp(f, dtype=np.float64)
    p[~np.isfinite(f)] = 0.0
    return p / p.sum()


def _sample(probs, key):
    """Inverse-CDF draw from ``probs`` with one uniform off ``key``."""
    u = uniform(key)
    cdf = np.cumsum(probs)
    return int(min(np.searchsorted(cdf, u * cdf[-1], side="right"),
                   len(probs) - 1))


def accept_greedy(target_rows, props):
    """Greedy token-match acceptance: ``target_rows`` ``[K+1, V]`` are the
    verify logits at positions ``pos..pos+K``, ``props`` the K draft
    tokens. Returns ``(accepted, emitted)``; ``emitted`` is always the
    accepted tokens and one more (the correction or bonus token from the
    first unmatched row), so a round never stalls."""
    a = 0
    for i, d in enumerate(props):
        if int(np.argmax(target_rows[i])) != int(d):
            break
        a += 1
    emitted = [int(t) for t in props[:a]]
    emitted.append(int(np.argmax(target_rows[a])))
    return a, emitted


def accept_sampled(target_rows, draft_rows, props, request_key, pos,
                   temperature, top_k, top_p):
    """Rejection-sampling acceptance (Leviathan/Chen): the emitted tokens
    are distributed exactly as vanilla sampling from the filtered target
    distribution. ``target_rows`` ``[K+1, V]`` (a tensor on any device, or
    numpy), ``draft_rows`` ``[K, V]`` (the draft's proposal logits),
    ``props`` the K proposals; ``pos`` is the round's base position (the
    last emitted token sits there). Returns ``(accepted, emitted)``."""
    host = (target_rows.float().cpu().numpy()
            if isinstance(target_rows, torch.Tensor)
            else np.asarray(target_rows, np.float32))
    a = 0
    emitted = []
    for i, d in enumerate(props):
        d = int(d)
        p = _dist(host[i], temperature, top_k, top_p)
        q = _dist(draft_rows[i], temperature, top_k, top_p)
        u = uniform(purpose_key(request_key, pos + i + 1, ACCEPT))
        if q[d] > 0 and u * q[d] <= p[d]:
            a += 1
            emitted.append(d)
            continue
        residual = np.maximum(p - q, 0.0)
        if residual.sum() <= 0:
            residual = p  # p == q exactly: any draw is distribution-true
        emitted.append(_sample(
            residual, purpose_key(request_key, pos + i + 1, RESIDUAL)))
        return a, emitted
    # everything accepted: the bonus token is the vanilla draw of the
    # verify's last row (Gumbel-max with the position key, on the row's
    # device), so an all-accept round consumes the address vanilla
    # decode would have
    row = torch.as_tensor(target_rows[len(props)])
    scaled = filter_logits(row[None, :], temperature, top_k, top_p)
    emitted.append(int(sample_rows(
        scaled, [(request_key, pos + len(props) + 1)])[0]))
    return a, emitted


# ------------------------------------------------------- verify programs


def build_verify_body(net, block, k1, sequential):
    """The one-launch verify body over ``block`` (per-layer ``(k, v)``
    caches ``[1, W, ...]``, written in place): ``body(ids, pos)`` scores
    ``ids`` ``[1, k1]`` at positions ``[pos, pos + k1)`` (``pos`` a ``[1]``
    int32 tensor) and returns the logits ``[k1, V]``.
    ``sequential=False`` is the parallel two-pass construction (float
    caches: chunk-write, then the broadcast re-read); ``True`` unrolls k1
    decode sub-steps (int8 caches: the vanilla data flow)."""

    if sequential:
        def body(ids, pos):
            rows = []
            for i in range(k1):
                lg, _ = decode_step(net, ids[:, i:i + 1], block, pos + i)
                rows.append(lg)
            return torch.cat(rows, 0)

        return body

    def body(ids, pos):
        net.model(ids, caches=block, pos=pos, apply_final_norm=False)
        rows = [(broadcast_rows(k, k1), broadcast_rows(v, k1))
                for k, v in block]
        at = pos + torch.arange(k1, dtype=torch.int32, device=pos.device)
        logits, _ = decode_step(net, ids.t().contiguous(), rows, at)
        return logits

    return body


def _row(cache, slot):
    """Row ``slot`` of a slab cache as a ``[1, S, ...]`` view."""
    if is_quantized(cache):
        return QuantizedKV(cache.q[slot:slot + 1],
                           cache.scale[slot:slot + 1])
    return cache[slot:slot + 1]


def _weights(net):
    """What a program over ``net`` reads besides its inputs."""
    if isinstance(net, _EarlyExitDraft):
        net = net.target
    return tuple(net.state_dict(keep_vars=True).values())


class _DraftSlot:
    """Draft cache state of one engine row: ``fed`` counts the tokens the
    draft has consumed (its positions ``[0, fed)`` are valid); -1 marks a
    fresh row, whose next round ingests the whole context."""

    __slots__ = ("fed",)

    def __init__(self):
        self.fed = -1


class SpeculativeDecoder:
    """Pairs a draft with the target inside a serving engine.

    ``draft``: a small causal LM sharing the target's vocabulary, or
    ``exit_layer=N`` for the self-speculative early exit. ``k`` is the
    proposal depth: each round emits 1..k+1 tokens for one verify
    launch. ``draft_cache_dtype`` is the draft cache's storage dtype.
    Pass it as ``speculative=`` to either engine, which binds it."""

    def __init__(self, draft=None, *, k=4, exit_layer=None,
                 draft_cache_dtype="bfloat16"):
        if (draft is None) == (exit_layer is None):
            raise ValueError(
                "pass exactly one of draft= (a small causal LM) or "
                "exit_layer= (self-speculative early exit)"
            )
        if int(k) < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        self.k = int(k)
        self.exit_layer = None if exit_layer is None else int(exit_layer)
        self.draft_cache_dtype = draft_cache_dtype
        self._draft_arg = draft
        self._eng = None
        self._draft = None
        self._pool = None   # the draft's pooled prefill blocks
        self._slab = None   # the draft cache, a row an engine row
        self._slots = {}
        self._sequential = False
        self.rounds = 0
        self.proposed = 0
        self.accepted = 0
        self.emitted = 0
        self.draft_ingests = 0
        self.draft_steps = 0

    @property
    def mode(self):
        return "self" if self.exit_layer is not None else "draft"

    # ------------------------------------------------------------ binding
    def bind(self, engine):
        """Attach to one engine (from its ``__init__``): resolve the
        draft, check it against the target, and allocate the draft's
        cache slab and pool."""
        if self._eng is not None:
            raise RuntimeError(
                "SpeculativeDecoder is already bound to an engine")
        if self.exit_layer is not None:
            draft = _EarlyExitDraft(engine.net, self.exit_layer)
        else:
            draft = self._draft_arg.eval()
            if draft.config.vocab_size != engine.config.vocab_size:
                raise ValueError(
                    f"draft vocab {draft.config.vocab_size} != target "
                    f"vocab {engine.config.vocab_size}")
            if draft.device != engine.device:
                raise ValueError(
                    f"the draft is on {draft.device}, the engine on "
                    f"{engine.device}")
        self._draft = draft
        # the slab's verify over an int8 block runs decode sub-steps; the
        # paged engine replays its decode step over the arena
        self._sequential = (engine.cache_dtype == torch.int8
                            and not engine._spec_verify_in_arena)
        self._pool = KVCachePool(
            draft.config, dtype=self.draft_cache_dtype,
            min_bucket=engine.pool.min_bucket,
            max_seq_len=engine.max_seq_len, device=engine.device)
        self._slab = self._pool.alloc_slab_arrays(engine.max_batch_size,
                                                  engine.max_seq_len)
        # the speculative inventory widens the engine's storm bar as in
        # JAX (``speculative.py:348``): draft prefill per bucket, verify
        # per (width, k1), draft decode and the gathers
        nb = len(engine._warmup_buckets())
        engine.trace_guard.max_compiles += nb * (self.k + 3) + 4
        self._eng = engine

    def unbind(self):
        """Engine close: drop the draft's cache and state."""
        self._eng = None
        self._pool = None
        self._slab = None
        self._slots.clear()

    def on_weights_swapped(self, engine):
        """Live reload landed (``speculative.py:359``): every draft cache
        was computed under the old weights, so each row re-ingests its
        context at its next round. The early-exit draft reads the
        target's own parameters, which the swap updated in place."""
        for st in self._slots.values():
            st.fed = -1

    def reset_slot(self, slot):
        """Row retired: its draft cache stays (stale content sits behind
        the position mask), the row is marked fresh."""
        st = self._slots.get(slot)
        if st is not None:
            st.fed = -1

    def stats(self):
        return {
            "mode": self.mode,
            "k": self.k,
            "exit_layer": self.exit_layer,
            "sequential_verify": self._sequential,
            "rounds": self.rounds,
            "proposed": self.proposed,
            "accepted": self.accepted,
            "emitted": self.emitted,
            "draft_ingests": self.draft_ingests,
            "draft_steps": self.draft_steps,
            "mean_accept_length": (
                round(self.emitted / self.rounds, 3) if self.rounds
                else None),
        }

    def reset_stats(self):
        """Zero the running counters."""
        self.rounds = self.proposed = 0
        self.accepted = self.emitted = 0
        self.draft_ingests = self.draft_steps = 0

    # ------------------------------------------------------ the programs
    def _build_dprefill(self, blk):
        """Draft prefill of one bucket: ids ``[1, bucket]`` through the
        draft into its pooled block, then the block into the draft slab's
        row ``slot`` (a ``[1]`` device tensor)."""
        draft, slab = self._draft, self._slab
        dev = self._eng.device
        inputs = [torch.zeros((1, blk.bucket), dtype=torch.int64, device=dev),
                  torch.zeros((1,), dtype=torch.int64, device=dev)]

        def body(ids, slot):
            draft(ids, caches=blk.caches, pos=0)
            for (dk, dv), (bk, bv) in zip(slab, blk.caches):
                adopt_into_slab(dk, bk, slot)
                adopt_into_slab(dv, bv, slot)
            return ()

        return body, inputs, (_weights(draft), slab, blk.caches)

    def _build_ddecode(self, slot):
        """Draft decode of engine row ``slot``: one token ``[1, 1]`` at
        ``pos`` (``[1]``) over that row of the draft slab -> (logits
        ``[1, V]``, argmax ``[1]``)."""
        draft = self._draft
        rows = [(_row(k, slot), _row(v, slot)) for k, v in self._slab]
        dev = self._eng.device
        inputs = [torch.zeros((1, 1), dtype=torch.int64, device=dev),
                  torch.zeros((1,), dtype=torch.int32, device=dev)]

        def body(tok, pos):
            logits, _ = decode_step(draft, tok, rows, pos)
            return logits, torch.argmax(logits, dim=-1)

        return body, inputs, (_weights(draft), self._slab)

    def _build_verify(self, blk, k1):
        eng = self._eng
        dev = eng.device
        inputs = [torch.zeros((1, k1), dtype=torch.int64, device=dev),
                  torch.zeros((1,), dtype=torch.int32, device=dev)]
        body = build_verify_body(eng.net, blk.caches, k1, self._sequential)
        return body, inputs, (eng._keep(), blk.caches)

    def warmup(self, eng, buckets):
        """Capture the speculative inventory (from the engine's
        ``warmup()``, after its own): draft prefill per bucket, draft
        decode per engine row, then the engine's verify programs
        (``_warm_spec_verify``: on the slab a verify per k1 in ``1..k+1``,
        the shorter chunks serving a request's last rounds, and its
        gather; none on the paged engine). Returns the programs
        captured."""
        n = 0
        for b in buckets:
            blk = self._pool.alloc(b)
            try:
                n += eng._programs.warm(
                    ("spec_dprefill", blk.bucket),
                    lambda: self._build_dprefill(blk),
                    np.zeros((1, blk.bucket), np.int64),
                    np.zeros((1,), np.int64))
            finally:
                self._pool.free(blk)
        for slot in range(eng.max_batch_size):
            n += eng._programs.warm(
                ("spec_ddecode", slot), lambda: self._build_ddecode(slot),
                np.zeros((1, 1), np.int64), np.zeros((1,), np.int32))
        n += eng._warm_spec_verify(self, buckets)
        # the warm runs wrote the draft slab: every row ingests afresh
        for st in self._slots.values():
            st.fed = -1
        return n

    # ---------------------------------------------------------- the round
    def _ddecode(self, eng, slot, tok, pos):
        """One draft decode step of row ``slot`` -> (logits, argmax); the
        argmax is read on the host, so the program's input mirrors are
        free again when this returns."""
        logits, top = eng._run_program(
            ("spec_ddecode", slot), lambda: self._build_ddecode(slot),
            np.array([[tok]], np.int64), np.array([pos], np.int32))
        self.draft_steps += 1
        return logits, int(top[0])

    def _propose(self, eng, slot, seq, pos, k_eff):
        """Draft side of one round: catch the draft cache up to ``pos``
        tokens consumed, then propose ``k_eff`` tokens. Returns
        (proposals, draft logits rows, the latter for sampling only)."""
        st = self._slots.get(slot)
        if st is None:
            st = self._slots[slot] = _DraftSlot()
        h = seq.handle
        if st.fed < 0 or st.fed > pos:
            # fresh row: ingest the context [0, pos) through the bucketed
            # draft prefill
            blk = self._pool.alloc(pos)
            try:
                ids = np.zeros((1, blk.bucket), np.int64)
                ids[0, :pos] = np.concatenate(
                    [h.request.input_ids, np.asarray(h.tokens, np.int64)]
                )[:pos]
                eng._run_program(
                    ("spec_dprefill", blk.bucket),
                    lambda: self._build_dprefill(blk), ids,
                    np.array([slot], np.int64))
            finally:
                self._pool.free(blk)
            st.fed = pos
            self.draft_ingests += 1
        prompt_len = h.request.prompt_len
        while st.fed < pos:
            # catch-up (at most one token a round: only an all-accepted
            # round leaves its bonus token unconsumed)
            j = st.fed
            tok = (h.request.input_ids[j] if j < prompt_len
                   else h.tokens[j - prompt_len])
            self._ddecode(eng, slot, int(tok), j)
            st.fed += 1
        props, qrows = [], []
        t = seq.last_tok
        for i in range(k_eff):
            logits, top = self._ddecode(eng, slot, t, pos + i)
            st.fed = pos + i + 1
            if eng.do_sample:
                row = logits[0].float().cpu().numpy()
                d = _sample(
                    _dist(row, eng.temperature, eng.top_k, eng.top_p),
                    purpose_key(seq.key, pos + i + 1, DRAFT))
                qrows.append(row)
            else:
                d = top
            props.append(d)
            t = d
        return props, qrows

    def decode_once(self, eng):
        """The engine's decode phase under speculation: one round per
        active row, one row after another. Returns the tokens emitted."""
        n = 0
        for slot in range(eng.max_batch_size):
            if eng._seqs[slot] is not None:
                n += self._round(eng, slot)
        return n

    def _round(self, eng, slot):
        seq = eng._seqs[slot]
        h = seq.handle
        req = h.request
        pos = seq.pos
        remaining = req.max_new_tokens - seq.emitted
        k_eff = min(self.k, remaining - 1)
        # backend capacity: the verify writes KV at [pos, pos + k_eff];
        # the paged engine claims pages here and may clamp (k_eff 0 is a
        # one-token verify, the vanilla step's data flow)
        k_eff = max(0, eng._spec_reserve(slot, pos + k_eff) - pos)
        t0 = eng.clock()
        props, qrows = [], []
        if k_eff:
            props, qrows = self._propose(eng, slot, seq, pos, k_eff)
        k1 = k_eff + 1
        ids = np.zeros((1, k1), np.int64)
        ids[0, 0] = seq.last_tok
        ids[0, 1:] = props
        vsp = None if h.trace is None else get_tracer().start_span(
            "engine.verify", h.trace, slot=slot, pos=pos,
        )
        logits = eng._spec_verify(slot, ids, pos)
        if eng.do_sample:
            a, out = accept_sampled(
                logits, qrows, props, seq.key, pos, eng.temperature,
                eng.top_k, eng.top_p)
        else:
            a, out = accept_greedy(logits.float().cpu().numpy(), props)
        dt = eng.clock() - t0
        # bookkeeping before emission: _append may finish the request
        # (EOS or max_new_tokens) and retire the row
        self.rounds += 1
        self.proposed += k_eff
        self.accepted += a
        self.emitted += len(out)
        h.spec_rounds = getattr(h, "spec_rounds", 0) + 1
        h.spec_emitted = getattr(h, "spec_emitted", 0) + len(out)
        tid = None if h.trace is None else h.trace.trace_id
        m = eng.metrics
        m.spec_rounds.inc()
        m.spec_proposed.inc(k_eff)
        m.spec_accepted.inc(a)
        m.spec_accept_length.observe(len(out), trace_id=tid)
        # per-SLO-class child bound at admission (zero label work here)
        (seq.slo_itl or m.itl).observe(dt / len(out))
        if vsp is not None:
            vsp.finish(proposed=k_eff, accepted=a, emitted=len(out))
        appended = 0
        for t in out:
            if eng._seqs[slot] is None:
                break  # EOS mid-burst: later tokens never happened
            eng._append(slot, int(t))
            appended += 1
        if eng._seqs[slot] is not None:
            new_pos = eng._seqs[slot].pos
            # the rejected tail: its pages go back to the pool, the draft
            # rewinds to the accepted prefix (its stale KV is masked until
            # the next round overwrites it)
            eng._spec_rollback(slot, new_pos)
            st = self._slots.get(slot)
            if st is not None and st.fed > new_pos:
                st.fed = new_pos
        return appended
