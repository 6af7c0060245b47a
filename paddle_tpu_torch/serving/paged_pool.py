"""Page arena freelist for the paged serving engine (counterpart of
``paddle_tpu/serving/paged_pool.py``).

K/V live in a page arena (``[num_pages + 1, page_size, kvH, D]`` per
layer x2) and a request claims only ``ceil(total_tokens / page_size)``
pages. Page id **0 is the reserved garbage page**: unallocated table
entries and free decode rows point at it, and it sits behind the
position mask (the paged attention kernel never reads it inside a row's
live range). Pages are claimed up front at admission, so decode never
runs out mid-sequence. The arena tensors live on the engine; the pool
owns the freelist and the accounting, and a drained server reads
``pages_in_use == 0``.
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from ..models.generation import cache_torch_dtype


class PagesExhausted(RuntimeError):
    """A claim the freelist cannot satisfy (admission backpressure)."""


class PagedKVPool:
    """Freelist and accounting over ``num_pages`` usable pages (page 0
    comes on top). ``claim(n)`` returns n ids or raises
    :class:`PagesExhausted`; ``release(ids)`` returns them. A double
    release or a foreign id raises."""

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
        self._in_use = set()
        self.claims = 0
        self.releases = 0

    def pages_for(self, total_tokens):
        """Pages a request of ``total_tokens`` (prompt + max_new) needs."""
        if total_tokens < 1:
            raise ValueError("total_tokens must be >= 1")
        return -(-int(total_tokens) // self.page_size)

    def table_width(self):
        """P_max: table columns covering ``max_seq_len`` slots."""
        return -(-self.max_seq_len // self.page_size)

    def alloc_arena_arrays(self):
        """Zeroed ``[num_pages + 1, page_size, kvH, D]`` x2 per layer."""
        cfg = self.config
        shape = (self.num_pages + 1, self.page_size, cfg.kv_heads,
                 cfg.head_dim)
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
        return len(self._in_use)

    def claim(self, n):
        """``n`` fresh page ids, or :class:`PagesExhausted` (nothing is
        claimed on failure)."""
        n = int(n)
        if n < 1:
            raise ValueError(f"claim of {n} pages")
        if n > len(self._free):
            raise PagesExhausted(
                f"need {n} pages, {len(self._free)} free "
                f"({len(self._in_use)} in use)"
            )
        ids = [self._free.pop() for _ in range(n)]
        self._in_use.update(ids)
        self.claims += n
        return ids

    def release(self, ids):
        """Return pages; the whole list is validated before any is
        released."""
        ids = [int(i) for i in ids]
        bad = [i for i in ids if i not in self._in_use]
        if bad:
            raise ValueError(
                f"page(s) {bad} not claimed (double release or foreign id?)"
            )
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate page ids in one release: {ids}")
        for i in ids:
            self._in_use.remove(i)
            self._free.append(i)
        self.releases += len(ids)

    def page_bytes(self):
        """Device bytes of one page across every layer's K and V."""
        cfg = self.config
        item = torch.empty((), dtype=self.dtype).element_size()
        return (2 * cfg.num_hidden_layers * self.page_size * cfg.kv_heads
                * cfg.head_dim * item)

    def arena_bytes(self):
        return (self.num_pages + 1) * self.page_bytes()
