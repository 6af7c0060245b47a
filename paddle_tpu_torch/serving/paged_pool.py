"""Page arena freelist for the paged serving engine (counterpart of
``paddle_tpu/serving/paged_pool.py``).

K/V live in a page arena (``[num_pages + 1, page_size, kvH, D]`` per
layer x2; an int8 arena is a ``QuantizedKV`` with ``[num_pages + 1,
page_size, kvH]`` fp32 scales beside the values) and a request claims only ``ceil(total_tokens / page_size)``
pages. Page id **0 is the reserved garbage page**: unallocated table
entries and free decode rows point at it, and it sits behind the
position mask (the paged attention kernel never reads it inside a row's
live range). Pages are refcounted (``paged_pool.py:76-93``): a claim
holds one reference, and the prefix cache and every request that adopts
a cached page hold one more each (:meth:`PagedKVPool.incref`); a page
returns to the freelist when its last reference drops. The arena
tensors live on the engine; the pool owns the freelist and the
accounting, and a drained server reads ``pages_in_use == 0`` and
``claims == releases``.
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from ..models.generation import cache_torch_dtype
from ..quantization.kv import alloc_quantized, kv_token_bytes


class PagesExhausted(RuntimeError):
    """A claim the freelist cannot satisfy (admission backpressure)."""


class PagedKVPool:
    """Freelist and accounting over ``num_pages`` usable pages (page 0
    comes on top). ``claim(n)`` returns n ids (one reference each) or
    raises :class:`PagesExhausted`; ``incref(ids)`` adds a reference to
    claimed pages; ``release(ids)`` drops one reference each, and a page
    is free again at zero. A release or incref of an unclaimed id
    raises."""

    def __init__(self, config, *, page_size=16, num_pages, dtype=None,
                 max_seq_len=4096, device=None):
        ps = int(page_size)
        if ps < 1 or (ps & (ps - 1)):
            raise ValueError(
                f"page_size must be a power of two, got {page_size}"
            )
        self.config = config
        self.page_size = ps
        self.num_pages = int(num_pages)
        if self.num_pages < 1:
            raise ValueError("need at least one usable page")
        self.max_seq_len = int(max_seq_len)
        self.dtype = cache_torch_dtype(dtype)
        self.device = resolve_device(device)
        self._free = list(range(1, self.num_pages + 1))[::-1]
        self._refs = {}  # page id -> references held
        self.claims = 0
        self.releases = 0  # pages returned to the freelist
        self.increfs = 0
        self.exhausted_events = 0
        self.peak_in_use = 0
        # sum of max(0, refcount - 2) over the pages: the private copies
        # that sharing avoids beyond (cache + first holder), kept as the
        # references move
        self._extra_shared_refs = 0

    def pages_for(self, total_tokens):
        """Pages a request of ``total_tokens`` (prompt + max_new) needs."""
        if total_tokens < 1:
            raise ValueError("total_tokens must be >= 1")
        return -(-int(total_tokens) // self.page_size)

    def table_width(self):
        """P_max: table columns covering ``max_seq_len`` slots."""
        return -(-self.max_seq_len // self.page_size)

    def alloc_arena_arrays(self):
        """Zeroed ``[num_pages + 1, page_size, kvH, D]`` x2 per layer
        (``QuantizedKV`` pairs for an int8 pool)."""
        cfg = self.config
        shape = (self.num_pages + 1, self.page_size, cfg.kv_heads,
                 cfg.head_dim)
        if self.dtype == torch.int8:
            return [(alloc_quantized(shape, self.device),
                     alloc_quantized(shape, self.device))
                    for _ in range(cfg.num_hidden_layers)]
        return [
            (torch.zeros(shape, dtype=self.dtype, device=self.device),
             torch.zeros(shape, dtype=self.dtype, device=self.device))
            for _ in range(cfg.num_hidden_layers)
        ]

    @property
    def free_pages(self):
        return len(self._free)

    @property
    def pages_in_use(self):
        return len(self._refs)

    @property
    def shared_pages(self):
        """Pages held by more than one reference."""
        return sum(1 for v in self._refs.values() if v > 1)

    @property
    def shared_saved_pages(self):
        """Private page copies that sharing avoids right now: the
        references past (cache + first holder) of every page."""
        return self._extra_shared_refs

    def refcount(self, page_id):
        return self._refs.get(int(page_id), 0)

    def claim(self, n):
        """``n`` fresh page ids (one reference each), or
        :class:`PagesExhausted` (nothing is claimed on failure)."""
        n = int(n)
        if n < 1:
            raise ValueError(f"claim of {n} pages")
        if n > len(self._free):
            self.exhausted_events += 1
            raise PagesExhausted(
                f"need {n} pages, {len(self._free)} free "
                f"({len(self._refs)} in use)"
            )
        ids = [self._free.pop() for _ in range(n)]
        for i in ids:
            self._refs[i] = 1
        self.claims += n
        self.peak_in_use = max(self.peak_in_use, len(self._refs))
        return ids

    def _validate(self, ids, verb):
        ids = [int(i) for i in ids]
        bad = [i for i in ids if i not in self._refs]
        if bad:
            raise ValueError(
                f"page(s) {bad} not claimed (cannot {verb} an unclaimed "
                f"page: double release or foreign id?)"
            )
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate page ids in one {verb}: {ids}")
        return ids

    def incref(self, ids):
        """Add one reference to each of these claimed pages (the prefix
        cache's hold on a published page, a request's on an adopted one);
        the whole list is validated first."""
        for i in self._validate(ids, "incref"):
            if self._refs[i] >= 2:
                self._extra_shared_refs += 1
            self._refs[i] += 1
            self.increfs += 1

    def release(self, ids):
        """Drop one reference per id; a page returns to the freelist at
        its last. The whole list is validated before any is released, so
        a raise releases nothing."""
        for i in self._validate(ids, "release"):
            if self._refs[i] >= 3:
                self._extra_shared_refs -= 1
            self._refs[i] -= 1
            if self._refs[i] == 0:
                del self._refs[i]
                self._free.append(i)
                self.releases += 1

    def page_bytes(self):
        """Device bytes of one page across every layer's K and V (an
        int8 page counts its fp32 scales)."""
        cfg = self.config
        return (2 * cfg.num_hidden_layers * self.page_size
                * kv_token_bytes(cfg.kv_heads, cfg.head_dim, self.dtype))

    def arena_bytes(self):
        return (self.num_pages + 1) * self.page_bytes()

    def stats(self):
        return {
            "dtype": str(self.dtype).replace("torch.", ""),
            "page_size": self.page_size,
            "num_pages": self.num_pages,
            "table_width": self.table_width(),
            "free_pages": self.free_pages,
            "pages_in_use": self.pages_in_use,
            "shared_pages": self.shared_pages,
            "peak_pages_in_use": self.peak_in_use,
            "increfs": self.increfs,
            "page_bytes": self.page_bytes(),
            "arena_bytes": self.arena_bytes(),
            "claims": self.claims,
            "releases": self.releases,
            "exhausted_events": self.exhausted_events,
        }
