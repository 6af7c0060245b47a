"""Paged continuous-batching engine (counterpart of the core of
``paddle_tpu/serving/paged_engine.py`` ``PagedServingEngine``).

K/V live in a page arena (:class:`~.paged_pool.PagedKVPool`) and each
request claims only ``ceil(total_tokens / page_size)`` pages. Per step:

- **prefill** (at most ``max_prefills_per_step`` per engine step, so a
  burst of long prompts delays running decodes by at most that many
  prefills): the bucketed prefill of the slab engine, into a pooled
  block;
- **adopt pages**: the block is scattered into the arena as
  ``bucket / page_size`` whole pages at the request's page ids (ids past
  its claim point at the garbage page 0);
- **decode step**: ``[B]`` tokens plus the ``[B, P]`` page table; each
  layer writes this step's k/v at every row's (page, offset) and attends
  through the paged attention kernel (``kernels/paged_attention.py``).

**Prefix cache** (``prefix_cache=True``, or a
:class:`~.prefix_cache.PrefixCache` over the engine's ``page_pool``):
full prompt pages are published under hash-chained keys at admission;
a new request adopts every cached page of its prompt by reference and
prefills only the tail:

- **gather pages** (one program a bucket): the cached pages, copied into
  the bucket's pooled block (``quantization.kv.gather_block_from_pages``);
- **chunk prefill** (one program a (bucket, tail bucket)): the tail ids
  ``[1, tail_bucket]`` at position ``c`` over that block, ``c`` a device
  input (the model's per-row path: rope by position ids, writes by
  rows), so one capture serves every ``c``;
- then the adopt, whose ids for the shared pages are the garbage page 0:
  a shared page is never written. A recompute boundary inside a cached
  page copies that page into a fresh one (``cow_clones``).

A finished request publishes the prompt and answer span its steps wrote
and the partial last page, so a second turn reuses them (``sessions=``
keeps the conversations' bookkeeping, ``sessions.py``). Prefix mode
also grows decode pages on demand (``demand_paging=`` sets it apart):
admission claims the prompt's pages only, a row claims the next page as
it crosses a page boundary, evicting cold cached pages (leaf-first LRU)
if it must, and a claim that still fails sheds that request with
``pages_exhausted``.

**The spill tier** (``kv_tiering=``, with a prefix cache): an evicted
cached page's bytes spill to a :class:`~.kv_tiering.TieredPageStore` in
host RAM (and disk), one frame a page id across every layer, and a
walk that meets a spilled page restores it into a fresh page through
the adopt program of the one-page bucket. A refused payload (budget,
CRC, stale weights, no page for it) falls back to a cold prefill,
counted.

**Speculative decoding** (``speculative=``, ``speculative.py``): a
round's verify is replays of the engine's own decode program, the
round's positions on its rows, over the arena (``_spec_verify``), so its
rows are the vanilla decode step's rows. Under demand paging the
verify's pages are claimed before the round (evicting if it must; under
pressure the round clamps its proposals instead of shedding anyone) and
the rejected tail's pages are released after it
(``spec_pages_claimed``, ``spec_pages_rolled_back``).

Every step is one of the engine's fixed-shape programs, CUDA graphs on a
card (``programs.py``; the page table, page ids, tail ids and ``c`` are
their device inputs), and ``warmup()`` captures them all before traffic.
A failing program raises: the admission releases what it claimed, and
nothing falls back to another path. A live reload (``engine.py``,
``reload.py``) flushes the prefix cache, and with it the spill tier,
with reason ``"weights_reload"``.

**Remote prefill** (``prefill_transport=``, a
:class:`~.fleet.kv_transfer.RemotePrefillClient`): a cold admission ships
its prompt to a prefill worker, and the pages that come back are copied
into the bucket's pooled block (pinned staging on a card) and adopted by
the same adopt program as a local prefill's block, so the arena is
bit-identical to a local prefill's. The sampling key is drawn once,
before the attempt, so a fallback consumes the key the local path
would. A transfer failure falls back to a local prefill
(``remote_prefill_fallbacks``); the prefill span's ``mode`` says
``remote``, ``local``, ``fallback`` or ``chunk``.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..models.generation import _select_next, normalize_cache_dtype
from ..observability.tracing import get_tracer
from ..quantization.kv import (
    adopt_into_pages,
    gather_block_from_pages,
    is_quantized,
)
from .engine import ServingEngine
from .kv_tiering import TieredPageStore
from .paged_pool import PagedKVPool, PagesExhausted
from .prefix_cache import PrefixCache
from .programs import BASE_KINDS, SPEC_KINDS, TRACE_KEYS
from .scheduler import CANCELLED, REASON_PAGES_EXHAUSTED


class PagedServingEngine(ServingEngine):
    """Continuous batching over a paged KV pool; the request surface of
    :class:`ServingEngine`. ``page_size`` is a power of two dividing
    ``min_bucket`` and ``max_seq_len``. ``num_pages`` (usable pages)
    defaults to full coverage, ``max_batch_size * max_seq_len /
    page_size``; ``page_pool`` passes a built pool instead.
    ``prefix_cache`` (True, or a ``PrefixCache`` over ``page_pool``)
    turns on prefix sharing; ``demand_paging`` defaults to it.
    ``kv_tiering`` (True, a dict of ``TieredPageStore`` arguments, or a
    built store) puts a spill tier below the prefix cache, which it
    requires."""

    _spec_verify_in_arena = True

    def __init__(self, net, *, max_batch_size=8, max_seq_len=256,
                 page_size=16, num_pages=None, cache_dtype=None,
                 do_sample=False, temperature=1.0, top_k=0, top_p=1.0,
                 seed=0, min_bucket=16, max_queue_size=64,
                 max_tokens_in_flight=None, max_prefills_per_step=1,
                 scheduler=None, metrics=None, pool=None, page_pool=None,
                 clock=time.monotonic, recompile_guard_max=None,
                 weights_version=None, prefill_transport=None,
                 reload_template=None, prefix_cache=None,
                 demand_paging=None, speculative=None,
                 kv_tiering=None, sessions=None, graphs=True):
        ps = int(page_size)
        if ps < 1 or (ps & (ps - 1)):
            raise ValueError(
                f"page_size must be a power of two, got {page_size}"
            )
        if ps > int(min_bucket) or int(min_bucket) % ps:
            raise ValueError(
                f"page_size {ps} must divide every prefill bucket: "
                f"min_bucket {min_bucket} must be a multiple of it"
            )
        if int(max_seq_len) % ps:
            raise ValueError(
                f"max_seq_len {max_seq_len} must be a multiple of "
                f"page_size {ps}"
            )
        if kv_tiering not in (None, False) \
                and prefix_cache in (None, False):
            raise ValueError(
                "kv_tiering requires prefix_cache: the tier spills and "
                "restores prefix-cache pages")
        self.page_size = ps
        self._kv_tiering_arg = kv_tiering
        self._num_pages_arg = num_pages
        self._page_pool_arg = page_pool
        self._prefix_cache_arg = prefix_cache
        self._demand_paging = (
            bool(demand_paging) if demand_paging is not None
            else prefix_cache not in (None, False)
        )
        self.max_prefills_per_step = (
            None if max_prefills_per_step is None
            else int(max_prefills_per_step)
        )
        # cross-process disaggregation: with a transport (a
        # fleet.kv_transfer.RemotePrefillClient) attached, admission ships
        # the prompt to the prefill pool and adopts the returned pages;
        # any transfer failure falls back to a LOCAL prefill, counted. A
        # prefix-cache hit skips the transport (the tail chunk is cheaper
        # than the wire)
        self.prefill_transport = prefill_transport
        self.remote_prefills = 0
        self.remote_prefill_fallbacks = 0
        self.local_prefills = 0
        self.chunk_prefills = 0
        # the prefix probe of the head the scheduler last asked about:
        # (request, (match, plan)), used by the admission that follows
        self._probe = None
        super().__init__(
            net, max_batch_size=max_batch_size, max_seq_len=max_seq_len,
            cache_dtype=cache_dtype, do_sample=do_sample,
            temperature=temperature, top_k=top_k, top_p=top_p, seed=seed,
            min_bucket=min_bucket, max_queue_size=max_queue_size,
            max_tokens_in_flight=max_tokens_in_flight, scheduler=scheduler,
            metrics=metrics, pool=pool, clock=clock,
            recompile_guard_max=recompile_guard_max,
            weights_version=weights_version,
            reload_template=reload_template, speculative=speculative,
            sessions=sessions, graphs=graphs,
        )
        if self.prefix_cache is not None and recompile_guard_max is None:
            # a gather per bucket and a chunk per (bucket, tail bucket)
            # are the steady-state inventory, not a storm; a spill tier
            # adds the one-page restore adopt (``paged_engine.py:176-
            # 185``)
            nb = len(self._warmup_buckets())
            self.trace_guard.max_compiles = max(
                self.trace_guard.max_compiles,
                nb * (nb + 3) // 2 + 2
                + (1 if self.kv_tier is not None else 0),
            )

    # ------------------------------------------------------- KV backend
    def _init_kv_backend(self):
        pp = self._page_pool_arg
        if pp is None:
            num_pages = self._num_pages_arg
            if num_pages is None:
                num_pages = (self.max_batch_size
                             * (-(-self.max_seq_len // self.page_size)))
            pp = PagedKVPool(
                self.config, page_size=self.page_size, num_pages=num_pages,
                dtype=self.cache_dtype, max_seq_len=self.max_seq_len,
                device=self.device,
            )
        elif pp.page_size != self.page_size or pp.dtype != self.cache_dtype:
            raise ValueError(
                f"page_pool (page_size {pp.page_size}, {pp.dtype}) does not "
                f"match the engine (page_size {self.page_size}, "
                f"{self.cache_dtype})")
        elif pp.table_width() * pp.page_size < self.max_seq_len:
            raise ValueError(
                f"page_pool covers {pp.table_width() * pp.page_size} tokens "
                f"< max_seq_len {self.max_seq_len}")
        self.page_pool = pp
        pc = self._prefix_cache_arg
        if pc is True:
            pc = PrefixCache(pp)
        elif pc in (None, False):
            pc = None
        elif pc.pool is not pp:
            raise ValueError(
                "prefix_cache wraps another PagedKVPool than this engine's: "
                "pass that pool as page_pool")
        self.prefix_cache = pc
        tier = self._kv_tiering_arg
        if tier is True:
            tier = TieredPageStore()
        elif isinstance(tier, dict):
            tier = TieredPageStore(**tier)
        elif tier in (None, False):
            tier = None
        self.kv_tier = tier
        if tier is not None:
            pc.attach_tier(tier, read_page=self._tier_read_page,
                           restore_page=self._tier_restore_page,
                           current_version=lambda: self.weights_version)
        self.table_width = pp.table_width()
        self._caches = pp.alloc_arena_arrays()
        self._tables = np.zeros((self.max_batch_size, self.table_width),
                                np.int32)
        self._row_pages = [None] * self.max_batch_size
        # (prompt tokens, prompt_len) of each row, for publishing
        self._row_meta = [None] * self.max_batch_size
        self._free_rows = list(range(self.max_batch_size))[::-1]
        # the verify pages of speculative rounds: every page claimed either
        # stays with the accepting request or comes back on rollback
        self.spec_pages_claimed = 0
        self.spec_pages_rolled_back = 0

    def _program_kinds(self):
        kinds = BASE_KINDS
        if self.prefix_cache is not None:
            kinds += ("gather", "chunk")
        if self.speculative is not None:
            kinds += SPEC_KINDS
        return kinds

    @property
    def free_rows(self):
        return len(self._free_rows)

    def _has_capacity(self):
        return bool(self._free_rows)

    def _too_long(self, req):
        # a request needing more pages than the whole arena would block
        # the strict-FIFO queue forever: reject it at submit
        return (super()._too_long(req)
                or self.page_pool.pages_for(req.total_tokens)
                > self.page_pool.num_pages)

    def _release_slot(self, slot):
        if self.speculative is not None:
            self.speculative.reset_slot(slot)
        pages = self._row_pages[slot]
        meta = self._row_meta[slot]
        if (pages and meta is not None and self.prefix_cache is not None
                and not self._closed):
            # the partial prompt-tail page becomes shareable once its
            # owner stops writing it (its prompt slots only)
            prompt, prompt_len = meta
            k = prompt_len // self.page_size
            if prompt_len % self.page_size and k < len(pages):
                self.prefix_cache.publish_partial(
                    prompt, prompt_len, pages[k], self.weights_version)
        if pages:
            self.page_pool.release(pages)
        if self.prefix_cache is not None:
            self.prefix_cache.update_gauges()
        self._row_pages[slot] = None
        self._row_meta[slot] = None
        self._tables[slot, :] = 0  # a free row reads/writes page 0
        self._free_rows.append(slot)

    def _finish(self, slot, status, reason=None):
        """Decode-publish, then the base transition: while the row's
        pages are live, every page the request wrote, prompt and answer,
        goes into the prefix chain. The last emitted token was never fed
        back, so ``prompt_len + emitted - 1`` positions publish."""
        seq = self._seqs[slot]
        meta = self._row_meta[slot]
        pages = self._row_pages[slot]
        if (seq is not None and self.prefix_cache is not None
                and not self._closed and pages and meta is not None):
            prompt, prompt_len = meta
            toks = prompt + tuple(int(t) for t in seq.handle.tokens)
            valid = prompt_len + max(0, len(seq.handle.tokens) - 1)
            if valid > prompt_len:
                self.prefix_cache.publish(toks, valid, pages,
                                          self.weights_version)
                k = valid // self.page_size
                if valid % self.page_size and k < len(pages):
                    self.prefix_cache.publish_partial(
                        toks, valid, pages[k], self.weights_version)
        super()._finish(slot, status, reason=reason)

    # --------------------------------------------------------- admission
    def _pages_at_admission(self, prompt_len, total_tokens):
        """Pages a request's table needs at admission: its whole span,
        or under demand growth the prompt's only."""
        return self.page_pool.pages_for(
            prompt_len if self._demand_paging else total_tokens)

    def _admission_budget(self):
        """The head must fit the in-flight token cap AND the free pages
        (``total <= free_pages * page_size`` is exactly ``ceil(total /
        page_size) <= free_pages``). In prefix or demand mode the page
        side is :meth:`_admission_fits`' (a warm request's need depends
        on what the cache covers)."""
        base = ServingEngine._admission_budget(self)
        if self._demand_paging or self.prefix_cache is not None:
            return base
        page_budget = self.page_pool.free_pages * self.page_size
        return page_budget if base is None else min(base, page_budget)

    def _admission_fits(self):
        if self.prefix_cache is None and not self._demand_paging:
            return None

        def fits(req):
            n_init = self._pages_at_admission(req.prompt_len,
                                              req.total_tokens)
            n_ref, ref_pages = 0, ()
            match, plan = self._prefix_probe(req)
            if plan is not None:
                n_ref = plan[0] // self.page_size
                ref_pages = match.pages[:n_ref]
            need = n_init - n_ref
            if need <= self.page_pool.free_pages:
                return True
            if self.prefix_cache is None:
                return False
            # the pages this request would adopt cannot be evicted for it
            return need <= (self.page_pool.free_pages
                            + self.prefix_cache.evictable_pages(
                                exclude=ref_pages))

        return fits

    def _prefix_probe(self, req):
        """One chain walk and chunk plan per admission attempt, shared by
        the fits predicate and the admission right after it: ``(match,
        plan)``, or ``(None, None)`` when no plan reuses anything."""
        if self.prefix_cache is None:
            return None, None
        m = self.prefix_cache.match(req.input_ids, req.prompt_len,
                                    self.weights_version)
        plan = None
        if m.covered > 0:
            plan = self._chunk_plan(req.prompt_len,
                                    self.pool.bucket_for(req.prompt_len),
                                    m.covered)
        out = (m if plan is not None else None, plan)
        self._probe = (req, out)
        return out

    def _max_admissions_per_step(self):
        return self.max_prefills_per_step

    def _tail_buckets(self, bucket):
        """The tail ladder of one prompt bucket: the power-of-two
        prefill ladder capped at the bucket."""
        out, n = [], self.pool.min_bucket
        while n < bucket:
            out.append(n)
            n *= 2
        out.append(bucket)
        return out

    def _chunk_plan(self, prompt_len, bucket, covered):
        """The warm admission's (recompute start ``c``, tail bucket): the
        most cached span reused, under ``c + tail_bucket <= bucket`` (the
        chunk writes ``[c, c + tail_bucket)`` of the block) and ``c <=
        prompt_len - 1`` (the last prompt token always runs: its logits
        give the first token). None when no plan reuses anything."""
        best = None
        for tb in self._tail_buckets(bucket):
            c = min(int(covered), prompt_len - 1, bucket - tb)
            if c <= 0 or prompt_len - c > tb:
                continue
            if best is None or c > best[0]:
                best = (c, tb)
        return best

    def _claim_pages(self, n):
        """``n`` fresh pages, evicting cold cached pages if the freelist
        is short; :class:`PagesExhausted` when both together cannot."""
        try:
            return self.page_pool.claim(n)
        except PagesExhausted:
            if self.prefix_cache is None:
                raise
            self.prefix_cache.evict(n - self.page_pool.free_pages)
            return self.page_pool.claim(n)

    def _admit_one(self, handle):
        req = handle.request
        now = self.clock()
        ps = self.page_size
        bucket = self.pool.bucket_for(req.prompt_len)
        n_init = self._pages_at_admission(req.prompt_len, req.total_tokens)
        key = self._next_key()
        match = plan = None
        if self.prefix_cache is not None:
            probe = self._probe
            if probe is None or probe[0] is not req:
                probe = (req, self._prefix_probe(req))
            self._probe = None
            match, plan = probe[1]
            if match is not None:
                self.prefix_cache.hits.inc()
                self.prefix_cache.tokens_saved.inc(plan[0])
            else:
                self.prefix_cache.misses.inc()
        n_ref = 0 if match is None else plan[0] // ps
        ref_pages = [] if match is None else match.pages[:n_ref]
        row = None
        owned = []
        t_start = self.clock()
        # the admission's prefill span, with the warm path's plan; None
        # (nothing allocated) when sampled out
        psp = None if handle.trace is None else get_tracer().start_span(
            "engine.prefill", handle.trace, bucket=bucket,
            prefix_hit=match is not None,
        )
        if psp is not None and plan is not None:
            psp.set(chunk_start=plan[0], tail_bucket=plan[1],
                    cached_tokens=plan[0])
        fb0 = self.remote_prefill_fallbacks
        # a cold admission tries the prefill pool first; its block (the
        # received pages in a pooled block) is this admission's to free
        remote = (self._remote_prefill(req, bucket, key, trace=psp)
                  if match is None else None)
        if psp is not None:
            psp.set(mode=(
                "chunk" if match is not None
                else "remote" if remote is not None
                else "fallback" if self.remote_prefill_fallbacks > fb0
                else "local"))
        blk = None if remote is None else remote[1]
        asp = None
        try:
            if n_ref:
                # reference the shared pages before any claim: a claim may
                # evict, and must see them in use
                self.page_pool.incref(ref_pages)
                owned.extend(ref_pages)
            fresh = self._claim_pages(n_init - n_ref)
            owned.extend(fresh)
            row = self._free_rows.pop()
            row_pages = ref_pages + fresh
            self._tables[row, :] = 0
            self._tables[row, :n_init] = row_pages
            if remote is not None:
                # the prefill pool ran the bucket program; its pages adopt
                # through the same adopt program as a local block's
                t0 = remote[0]
            elif match is None:
                self.local_prefills += 1
                t0, blk = self._prefill(req, key)
            else:
                t0, blk = self._chunk_prefill(req, key, bucket, match, plan,
                                              span=psp)
            if psp is not None:
                psp.finish()
                psp = None
                asp = get_tracer().start_span("engine.adopt", handle.trace,
                                              bucket=bucket)
            # the fresh pages within the block land in the claim; the
            # shared ones (indices < n_ref) and the block's pad pages go to
            # the garbage page 0: a shared page is never written
            ids = np.zeros((bucket // ps,), np.int64)
            k1 = min(n_init, bucket // ps)
            ids[n_ref:k1] = row_pages[n_ref:k1]
            self._run_adopt(blk, ids)
            self.pool.free(blk)
            blk = None
            if self.prefix_cache is not None:
                # full prompt pages are final once written (decode writes
                # start at prompt_len): later requests hit them at once
                self.prefix_cache.publish(req.input_ids, req.prompt_len,
                                          row_pages, self.weights_version)
        except BaseException:
            for sp in (psp, asp):
                if sp is not None:
                    sp.finish(error="admission_error")
            if blk is not None:
                # the failed admission's block (a received one, or one a
                # prefill filled) goes back to the pool
                self.pool.free(blk)
            if row is not None:
                self._tables[row, :] = 0
                self._free_rows.append(row)
            if owned:
                self.page_pool.release(owned)
            raise
        if asp is not None:
            asp.finish()
        dt = self.clock() - t_start
        self.metrics.prefill_time.observe(dt)
        if match is not None:
            self.metrics.warm_prefill_time.observe(dt)
        self._row_pages[row] = row_pages
        self._row_meta[row] = (tuple(int(t) for t in req.input_ids),
                               req.prompt_len)
        self._start_seq(handle, row, t0, key, now)

    # ---------------------------------------------- remote prefill
    def _remote_prefill(self, req, bucket, key, trace=None):
        """Try the attached prefill pool (JAX ``paged_engine.py:754-
        776``): ``(first token, block)``, the received pages copied into
        the bucket's pooled block (live: the caller adopts and frees it),
        or None when the transport is absent, cooling down or failing (the
        caller prefills locally; a failure counts in
        ``remote_prefill_fallbacks``). ``trace`` (the admission's prefill
        span) parents the transport's wire span."""
        tr = self.prefill_transport
        if tr is None or not tr.available():
            return None
        from .fleet.kv_transfer import TransferError

        try:
            t0, flat = tr.prefill(
                [int(t) for t in req.input_ids], req.prompt_len, bucket,
                self.page_size, normalize_cache_dtype(self.cache_dtype),
                float(self.temperature), key, trace=trace,
            )
            blk = self.pool.alloc(req.prompt_len)
            try:
                self._load_block(blk, flat)
            except BaseException:
                self.pool.free(blk)
                raise
        except TransferError:
            self.remote_prefill_fallbacks += 1
            return None
        self.remote_prefills += 1
        return t0, blk

    def _load_block(self, blk, flat):
        """Copy a received flat block (CPU tensors, per layer K then V)
        into ``blk``'s caches on the current stream, through pinned
        staging on a card: the adopt program reads the pooled block at its
        address, so the bytes go into it, unchanged. A block of another
        geometry is a :class:`TransferError`."""
        from .fleet.kv_transfer import TransferError, _flat_leaves

        dst = self._page_leaves(blk.caches)
        src = _flat_leaves(flat)
        if len(src) != len(dst) or any(
                s.shape != d.shape or s.dtype != d.dtype
                for s, d in zip(src, dst)):
            raise TransferError(
                f"received block does not match the bucket-{blk.bucket} "
                f"block of this engine")
        pin = self.device.type == "cuda"
        with torch.inference_mode():
            for s, d in zip(src, dst):
                # a pinned copy is asynchronous; the host allocator keeps
                # the staging buffer until the stream has read it
                d.copy_(s.pin_memory() if pin else s, non_blocking=pin)

    # --------------------------------------------------- the warm path
    def _gather_body(self, blk):
        """Copy ``bucket / page_size`` arena pages at ``page_ids`` (a
        device tensor) into ``blk``, in place."""
        ps, caches = self.page_size, self._caches
        n_blk = blk.bucket // ps

        def body(page_ids):
            for (ak, av), (bk, bv) in zip(caches, blk.caches):
                gather_block_from_pages(ak, page_ids, n_blk, ps, bk)
                gather_block_from_pages(av, page_ids, n_blk, ps, bv)
            return ()
        return body

    def _build_gather(self, blk):
        ids = torch.zeros((blk.bucket // self.page_size,), dtype=torch.int64,
                          device=self.device)
        return self._gather_body(blk), [ids], (self._caches, blk.caches)

    def _chunk_body(self, blk):
        """The chunk prefill: tail ids ``[1, tail_bucket]`` at the
        position in ``pos`` (a ``[1]`` device tensor, so that one capture
        serves every start) over ``blk`` -> logits ``[1, tail_bucket,
        V]``."""
        net = self.net

        def body(ids, pos):
            return net(ids, caches=blk.caches, pos=pos)[0]
        return body

    def _build_chunk(self, blk, tail_bucket):
        dev = self.device
        inputs = [torch.zeros((1, tail_bucket), dtype=torch.int64, device=dev),
                  torch.zeros((1,), dtype=torch.int32, device=dev)]
        return self._chunk_body(blk), inputs, (self._keep(), blk.caches)

    def _chunk_prefill(self, req, key, bucket, match, plan, span=None):
        """The warm admission's prefill -> (first token, block): the
        cached pages gathered into the bucket's block, then the tail
        from ``c`` chunk-prefilled over it. ``span`` (the admission's
        prefill span) parents an ``engine.gather`` span."""
        ps = self.page_size
        c, tb = plan
        n = req.prompt_len - c
        src = np.zeros((bucket // ps,), np.int64)
        n_gather = -(-c // ps)
        src[:n_gather] = match.pages[:n_gather]
        tail = np.zeros((1, tb), np.int64)
        tail[0, :n] = req.input_ids[c:]
        pos = np.array([c], np.int32)
        blk = self.pool.alloc(req.prompt_len)
        try:
            with torch.inference_mode():
                gsp = None if span is None else get_tracer().start_span(
                    "engine.gather", span, pages=n_gather)
                if self.graphs:
                    self._check_net()
                    self._programs.run(("gather", bucket),
                                       lambda: self._build_gather(blk), src)
                    if gsp is not None:
                        gsp.finish()
                    logits = self._programs.run(
                        ("chunk", bucket, tb),
                        lambda: self._build_chunk(blk, tb), tail, pos)
                else:
                    dev = self.device
                    self._gather_body(blk)(torch.from_numpy(src).to(dev))
                    if gsp is not None:
                        gsp.finish()
                    logits = self._chunk_body(blk)(
                        torch.from_numpy(tail).to(dev),
                        torch.from_numpy(pos).to(dev))
                # read on the host here, before any later admission
                # refills the gather's, chunk's or adopt's pinned input
                # mirrors (programs.py); the sampled token lands at
                # c + n = prompt_len, as on the cold path
                nxt = _select_next(
                    logits[:, n - 1, :], self.do_sample, self.temperature,
                    self.top_k, self.top_p, [(key, req.prompt_len)])
                t0 = int(nxt[0])
        except BaseException:
            self.pool.free(blk)
            raise
        self.chunk_prefills += 1
        if c % ps:
            # the boundary lies inside a cached page: the gather copied
            # it into the block, the adopt writes it into a fresh page
            self.prefix_cache.cow_clones.inc()
        return t0, blk

    def _warm_more(self, buckets):
        """With a prefix cache, a gather per bucket and a chunk prefill per
        (bucket, tail bucket) after the base inventory, in the JAX
        engine's order (``paged_engine.py:965-1013``); 17 + 8 + 36
        programs at 2048 slots from bucket 16. With a spill tier, the
        restore's adopt of the one-page bucket, which the base inventory
        already holds when that bucket is warmed (the JAX engine dedups it
        the same way, ``:1014-1020``)."""
        if self.prefix_cache is None:
            return 0
        warmed = 0
        for b in buckets:
            blk = self.pool.alloc(b)
            try:
                warmed += self._programs.warm(
                    ("gather", blk.bucket), lambda: self._build_gather(blk),
                    np.zeros((blk.bucket // self.page_size,), np.int64))
                for tb in self._tail_buckets(blk.bucket):
                    warmed += self._programs.warm(
                        ("chunk", blk.bucket, tb),
                        lambda: self._build_chunk(blk, tb),
                        np.zeros((1, tb), np.int64),
                        np.zeros((1,), np.int32))
            finally:
                self.pool.free(blk)
        if self.kv_tier is not None:
            blk = self._page_block()
            try:
                warmed += self._programs.warm(
                    ("adopt", blk.bucket), lambda: self._build_adopt(blk),
                    self._adopt_zeros(blk))
            finally:
                self.pool.free(blk)
        return warmed

    # ------------------------------------------------------- KV tiering
    @staticmethod
    def _page_leaves(caches):
        """The raw buffers of ``caches`` in frame order: per layer K then
        V, an int8 cache's codes then scales."""
        out = []
        for pair in caches:
            for t in pair:
                out += [t.q, t.scale] if is_quantized(t) else [t]
        return out

    def _tier_read_page(self, page_id):
        """One page id's bytes across every layer's arena, copied to the
        host, one tensor a buffer (the spill side). Read-only: a shared
        page is copied, never written."""
        with torch.inference_mode():
            return [t[page_id].to("cpu")
                    for t in self._page_leaves(self._caches)]

    def _page_block(self, arrays=None):
        """The pooled block of the bucket that holds one page, its first
        ``page_size`` slots holding the spilled ``arrays`` (a restore) or
        zeros (warmup). Returns the block, live; the caller frees it."""
        ps = self.page_size
        blk = self.pool.alloc(ps)
        # copies from pageable host memory wait for the stream: the last
        # restore's adopt (and its page-id copy from the program's pinned
        # mirror) has finished before the next restore refills the mirror
        with torch.inference_mode():
            for i, t in enumerate(self._page_leaves(blk.caches)):
                if arrays is None:
                    t[0, :ps].zero_()
                else:
                    t[0, :ps].copy_(arrays[i])
        return blk

    def _tier_restore_page(self, arrays):
        """The restore side: claim one fresh page straight from the pool
        (never through ``_claim_pages``, whose eviction could spill the
        chain being walked), adopt the spilled bytes into it through the
        adopt program of the one-page bucket (``("adopt", page_size)``
        when the page is the smallest bucket; a copy, so the bytes land
        bit-identical), and return its id; None when the pool has no free
        page."""
        try:
            page = self.page_pool.claim(1)[0]
        except PagesExhausted:
            return None
        try:
            blk = self._page_block(arrays)
            try:
                ids = np.zeros((blk.bucket // self.page_size,), np.int64)
                ids[0] = page
                self._run_adopt(blk, ids)
            finally:
                self.pool.free(blk)
        except BaseException:
            self.page_pool.release([page])
            raise
        return page

    # ------------------------------------- speculative backend seams
    def _spec_reserve(self, slot, hi):
        """Claim pages so row ``slot`` holds KV through position ``hi``
        (the verify writes ``[pos, hi]``), appended to the row's pages and
        table like any demand growth (evicting cold cached pages if it
        must). Under page pressure the round clamps to what the pool
        covers, at worst the row's current position (a one-token verify),
        instead of shedding anyone."""
        hi = min(hi, self.max_seq_len - 1)
        pages = self._row_pages[slot]
        ps = self.page_size
        while hi // ps >= len(pages):
            try:
                new = self._claim_pages(1)
            except PagesExhausted:
                break
            self._tables[slot, len(pages)] = new[0]
            pages.append(new[0])
            self.spec_pages_claimed += 1
        return min(hi, len(pages) * ps - 1)

    def _spec_verify(self, slot, ids, pos):
        """Score ``ids`` (``[1, k1]``) at positions ``[pos, pos + k1)`` of
        row ``slot`` as replays of the engine's own decode program: rows
        ``0..k1-1`` carry the row's page table and token ``ids[0, i]`` at
        position ``pos + i``; the other rows the garbage page 0, as free
        rows do. The step writes every row's K/V into the arena before
        the paged kernel reads, so at every layer row i reads what rows
        ``0..i-1`` wrote in the same step: the bytes the vanilla steps at
        ``pos..pos+i-1`` write, through the vanilla step's row count, and
        row i's logits are the vanilla step's row. More positions than
        ``max_batch_size`` take more replays, each reading what the last
        wrote. The writes land in the row's own pages (``pos >=
        prompt_len``; shared prefix pages end below it). Each replay
        counts under ``serving::spec_verify``. Returns the logits ``[k1,
        V]``, valid until the next decode replay."""
        b = self.max_batch_size
        k1 = int(ids.shape[1])
        rows = []
        for lo in range(0, k1, b):
            n = min(b, k1 - lo)
            tok = np.zeros((b, 1), np.int64)
            tok[:n, 0] = ids[0, lo:lo + n]
            at = np.zeros((b,), np.int32)
            at[:n] = pos + lo + np.arange(n)
            table = np.zeros_like(self._tables)
            table[:n] = self._tables[slot]
            with torch.inference_mode():
                logits, _ = self._run_program(
                    ("decode",), self._build_decode, tok, at, table)
            if self.graphs and self.speculative is not None:
                self._programs.counts[TRACE_KEYS["spec_verify"]] += 1
            if lo + n < k1:
                # the next replay overwrites these logits and refills the
                # program's pinned input mirrors: keep a copy, and let this
                # replay's input copies finish first
                logits = logits.clone()
                if self.device.type == "cuda":
                    torch.cuda.current_stream(self.device).synchronize()
            rows.append(logits[:n])
        return rows[0] if len(rows) == 1 else torch.cat(rows)

    def _warm_spec_verify(self, spec, buckets):
        """The verify replays the decode program of the base inventory:
        nothing more to capture."""
        return 0

    def _spec_rollback(self, slot, new_pos):
        """Release the rejected tail's pages (past the page that holds
        ``new_pos``) and zero their table entries. Without demand paging
        the row keeps its whole span."""
        if not self._demand_paging:
            return
        pages = self._row_pages[slot]
        keep = new_pos // self.page_size + 1
        if len(pages) <= keep:
            return
        tail = pages[keep:]
        del pages[keep:]
        self._tables[slot, keep:keep + len(tail)] = 0
        self.page_pool.release(tail)
        self.spec_pages_rolled_back += len(tail)

    # ------------------------------------------------------ the programs
    def _adopt_zeros(self, blk):
        return np.zeros((blk.bucket // self.page_size,), np.int64)

    def _adopt_body(self, blk):
        """Scatter the prefilled block into the arena at ``page_ids`` (a
        device tensor), whole pages, in place."""
        ps, caches = self.page_size, self._caches
        n_blk = blk.bucket // ps

        def body(page_ids):
            for (ak, av), (bk, bv) in zip(caches, blk.caches):
                adopt_into_pages(ak, bk, page_ids, n_blk, ps)
                adopt_into_pages(av, bv, page_ids, n_blk, ps)
            return ()
        return body

    def _decode_table(self):
        return self._tables

    # ------------------------------------------------------ decode loop
    def _grow_pages(self):
        """Demand growth before the decode step: a row whose next write
        crosses into an unclaimed page claims one (evicting if it must);
        a claim that still fails sheds that request with
        ``pages_exhausted`` (its tokens kept)."""
        ps = self.page_size
        for i, seq in enumerate(self._seqs):
            if seq is None:
                continue
            pages = self._row_pages[i]
            while seq.pos // ps >= len(pages):
                try:
                    new = self._claim_pages(1)
                except PagesExhausted:
                    self.metrics.sheds.inc(label=REASON_PAGES_EXHAUSTED)
                    self._finish(i, CANCELLED,
                                 reason=REASON_PAGES_EXHAUSTED)
                    break
                self._tables[i, len(pages)] = new[0]
                pages.append(new[0])

    def _decode_once(self):
        if self._demand_paging:
            self._grow_pages()
        super()._decode_once()

    def _on_weights_swapped(self):
        # every cached page (and every spilled one) holds KV computed
        # under the weights that just rotated out; the swap applies with
        # nothing in flight, so the cache holds the only reference to
        # every page and the flush returns them all to the free list
        if self.prefix_cache is not None:
            self.prefix_cache.flush(reason="weights_reload")
        super()._on_weights_swapped()

    def close(self):
        super().close()
        if self.prefix_cache is not None:
            self.prefix_cache.flush(reason="engine_closed")
        if self.prefill_transport is not None:
            self.prefill_transport.close()
        self._tables = None
