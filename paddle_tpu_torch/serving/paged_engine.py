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

Each of the three is one of the engine's fixed-shape programs, CUDA
graphs on a card (``programs.py``; the page table and the adopted page
ids are their device inputs), and ``warmup()`` captures them all before
traffic, as in the slab engine. Not ported in this slice: the prefix
cache (and the gather and chunk-prefill programs its warmup adds),
demand paging, KV tiering, remote prefill and speculative decoding.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..quantization.kv import adopt_into_pages
from .engine import ServingEngine
from .paged_pool import PagedKVPool


class PagedServingEngine(ServingEngine):
    """Continuous batching over a paged KV pool; the request surface of
    :class:`ServingEngine`. ``page_size`` is a power of two dividing
    ``min_bucket`` and ``max_seq_len``. ``num_pages`` (usable pages)
    defaults to full coverage, ``max_batch_size * max_seq_len /
    page_size``."""

    def __init__(self, net, *, max_batch_size=8, max_seq_len=256,
                 page_size=16, num_pages=None, cache_dtype=None,
                 do_sample=False, temperature=1.0, top_k=0, top_p=1.0,
                 seed=0, min_bucket=16, max_queue_size=64,
                 max_tokens_in_flight=None, max_prefills_per_step=1,
                 clock=time.monotonic, graphs=True):
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
        self.page_size = ps
        self._num_pages_arg = num_pages
        self.max_prefills_per_step = (
            None if max_prefills_per_step is None
            else int(max_prefills_per_step)
        )
        super().__init__(
            net, max_batch_size=max_batch_size, max_seq_len=max_seq_len,
            cache_dtype=cache_dtype, do_sample=do_sample,
            temperature=temperature, top_k=top_k, top_p=top_p, seed=seed,
            min_bucket=min_bucket, max_queue_size=max_queue_size,
            max_tokens_in_flight=max_tokens_in_flight, clock=clock,
            graphs=graphs,
        )

    # ------------------------------------------------------- KV backend
    def _init_kv_backend(self):
        num_pages = self._num_pages_arg
        if num_pages is None:
            num_pages = (self.max_batch_size
                         * (-(-self.max_seq_len // self.page_size)))
        pp = PagedKVPool(
            self.config, page_size=self.page_size, num_pages=num_pages,
            dtype=self.cache_dtype, max_seq_len=self.max_seq_len,
            device=self.device,
        )
        self.page_pool = pp
        self.table_width = pp.table_width()
        self._caches = pp.alloc_arena_arrays()
        self._tables = np.zeros((self.max_batch_size, self.table_width),
                                np.int32)
        self._row_pages = [None] * self.max_batch_size
        self._free_rows = list(range(self.max_batch_size))[::-1]

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

    def _admission_budget(self):
        """The head must fit the in-flight token cap AND the free pages
        (``total <= free_pages * page_size`` is exactly ``ceil(total /
        page_size) <= free_pages``)."""
        base = ServingEngine._admission_budget(self)
        page_budget = self.page_pool.free_pages * self.page_size
        return page_budget if base is None else min(base, page_budget)

    def _max_admissions_per_step(self):
        return self.max_prefills_per_step

    def _claim_row(self, req):
        pages = self.page_pool.claim(
            self.page_pool.pages_for(req.total_tokens))
        row = self._free_rows.pop()
        self._row_pages[row] = pages
        self._tables[row, :] = 0
        self._tables[row, :len(pages)] = pages
        return row

    def _release_slot(self, slot):
        pages = self._row_pages[slot]
        if pages:
            self.page_pool.release(pages)
        self._row_pages[slot] = None
        self._tables[slot, :] = 0  # a free row reads/writes page 0
        self._free_rows.append(slot)

    def _adopt_index(self, row, blk):
        """The block's page ids: the row's pages, then the garbage page 0
        for block pages past the request's claim."""
        ids = self._adopt_zeros(blk)
        pages = self._row_pages[row]
        k1 = min(len(pages), len(ids))
        ids[:k1] = pages[:k1]
        return ids

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

    def _adopt(self, row, blk):
        self._adopt_body(blk)(
            torch.from_numpy(self._adopt_index(row, blk)).to(self.device))

    def _decode_table(self):
        return self._tables

    def close(self):
        super().close()
        self._tables = None
