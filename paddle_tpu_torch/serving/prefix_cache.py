"""Hash-chained prefix page store: copy-on-write KV sharing for the paged
engine (counterpart of ``paddle_tpu/serving/prefix_cache.py``, pure
Python in both packages; the port keeps its own copy).

- **Keys are hash chains at page granularity.** A published page is
  keyed by ``(parent_key, its page_size tokens)``, the chain rooted at
  ``(weights_version, cache_dtype)`` (:meth:`PrefixCache.root_key`).
  Keys are the token tuples themselves, so they cannot collide, and a
  new weights version roots a new keyspace.
- **Adoption is by reference.** A new request walks the chain
  (:meth:`PrefixCache.match`) and adopts every matching full page into
  its page table with a pool reference (``PagedKVPool.incref``); the
  engine then prefills only the uncached tail (the chunk prefill).
- **Copy-on-write.** When the recompute boundary falls inside a cached
  page, the engine gathers that page into the prefill block, the chunk
  overwrites the tail, and the adopt writes the block page into a fresh
  page the request owns; the shared original is never written.
- **Eviction is leaf-first LRU** (:meth:`PrefixCache.evict`): only pages
  whose one reference is the cache's own, and only entries whose cached
  descendants are reclaimable too.

- **Spill instead of drop** (:meth:`PrefixCache.attach_tier`, a
  :class:`~.kv_tiering.TieredPageStore`): an evicted page's bytes go to
  the tier, and a chain walk that breaks at a spilled page restores it
  into a fresh arena page and walks on. Where the arena has no free page
  for a restore, the port spills one colder page outside the walk to
  make room (the JAX store leaves the record spilled then, so in a full
  arena it never restores: ``ROADMAP.md`` queue C).

What a published page holds is a function of its tokens under fixed
weights: full prompt pages at admission, the partial prompt-tail page at
release, and at finish the prompt and answer span the decode steps
wrote (``PagedServingEngine._finish``). Where decode-written KV is not
bit-equal to a prefill of the same tokens (``ROADMAP.md`` queue C), a
second turn reads the decode step's values, as the JAX engine does.

The counters are one set per cache, registered in the process registry
(or ``registry=``) under JAX's names with replace-on-register.
"""
from __future__ import annotations

import heapq
import itertools

from ..observability import get_registry
from .metrics import Counter, Gauge


class PrefixEntry:
    """One cached page: its chain key, the arena page holding its KV,
    the tokens it covers, and how many leading slots hold published
    content (``valid_len < page_size`` for a partial tail page)."""

    __slots__ = ("key", "parent", "page", "tokens", "valid_len",
                 "last_hit")

    def __init__(self, key, parent, page, tokens, valid_len, tick):
        self.key = key
        self.parent = parent
        self.page = int(page)
        self.tokens = tuple(int(t) for t in tokens)
        self.valid_len = int(valid_len)
        self.last_hit = tick

    @property
    def full(self):
        return self.valid_len == len(self.tokens)

    def __repr__(self):
        return (f"PrefixEntry(page={self.page}, "
                f"tokens={len(self.tokens)}, valid={self.valid_len})")


class PrefixMatch:
    """Result of one chain walk: the full-page entries matched in order,
    an optional partial-tail entry covering the rest of the prompt, and
    the covered token count."""

    __slots__ = ("entries", "tail", "covered")

    def __init__(self, entries, tail, covered):
        self.entries = entries
        self.tail = tail
        self.covered = int(covered)

    @property
    def pages(self):
        """Matched arena page ids, chain order (tail last when hit)."""
        out = [e.page for e in self.entries]
        if self.tail is not None:
            out.append(self.tail.page)
        return out


class PrefixCache:
    """Content-addressed page store over one :class:`PagedKVPool`.

    The cache holds one pool reference per published page; requests
    adopting a page hold their own (the engine increfs at admission and
    releases at finish). A page is evictable only while the cache's
    reference is its last. Not thread-safe: the engine's loop owns it."""

    def __init__(self, pool, *, registry=None,
                 namespace="paddle_serving"):
        self.pool = pool
        self.page_size = int(pool.page_size)
        self._entries = {}    # key -> PrefixEntry
        self._children = {}   # parent key -> set of child keys
        self._tick = itertools.count()
        self.flushes = 0
        ns = namespace
        self.hits = Counter(
            "prefix_hits", prom_name=f"{ns}_prefix_hits_total",
            help="admissions that adopted at least one cached prefix "
                 "page")
        self.misses = Counter(
            "prefix_misses", prom_name=f"{ns}_prefix_misses_total",
            help="admissions that found no usable cached prefix")
        self.evictions = Counter(
            "prefix_evictions",
            prom_name=f"{ns}_prefix_evictions_total",
            help="cached prefix pages reclaimed under arena pressure")
        self.cow_clones = Counter(
            "prefix_cow_clones",
            prom_name=f"{ns}_prefix_cow_clones_total",
            help="shared pages copy-on-write cloned for a divergent "
                 "tail")
        self.tokens_saved = Counter(
            "prefix_tokens_saved",
            prom_name=f"{ns}_prefix_tokens_saved_total",
            help="prompt tokens NOT re-prefilled thanks to cache hits")
        self.hbm_saved = Gauge(
            "prefix_shared_hbm_saved",
            prom_name=f"{ns}_prefix_shared_hbm_saved_bytes",
            help="arena bytes saved by page sharing: pages that would "
                 "be private copies without the prefix cache")
        (registry or get_registry()).register_all([
            self.hits, self.misses, self.evictions, self.cow_clones,
            self.tokens_saved, self.hbm_saved,
        ])
        self._tier = None
        self._read_page = None
        self._restore_page = None
        self._current_version = None

    # ---------------------------------------------------------- keying
    def root_key(self, weights_version):
        return ("prefix-root", str(weights_version),
                str(self.pool.dtype).replace("torch.", ""))

    # ----------------------------------------------------------- tiering
    def attach_tier(self, tier, *, read_page, restore_page,
                    current_version):
        """Attach a :class:`~.kv_tiering.TieredPageStore` below this
        cache. ``read_page(page_id)`` gives the page's host arrays (the
        spill side); ``restore_page(arrays)`` claims a fresh arena page,
        adopts the bytes and returns its id, or None when the arena has
        no free page; ``current_version()`` is the engine's weights
        version, stamped into every spilled payload for the stale
        refusal. The engine wires these at construction."""
        self._tier = tier
        self._read_page = read_page
        self._restore_page = restore_page
        self._current_version = current_version

    def _restore(self, child_key, parent, weights_version, walked):
        """Pull one spilled page back into the arena as a live entry, or
        None (absent, refused, or no page for it). With no free page, one
        reclaimable page outside ``walked`` (the pages this walk holds)
        spills to make room. The tier record is consumed before the entry
        lands, so a later publish of the key never meets stale bytes."""
        tier = self._tier
        if tier is None or self._restore_page is None:
            return None
        got = tier.get(child_key, weights_version=weights_version)
        if got is None:
            return None
        rec, _meta, arrays = got
        if self.pool.free_pages == 0:
            self.evict(1, exclude=walked)
        page = self._restore_page(arrays)
        if page is None:
            return None  # no page for it now: it stays spilled
        tier.pop(child_key, restored=True)
        e = self._add(child_key, parent, page, rec.tokens, rec.valid_len)
        # _add holds the cache's reference; drop the restore's claim
        self.pool.release([page])
        self.update_gauges()
        return e

    # --------------------------------------------------------- matching
    def match(self, tokens, prompt_len, weights_version):
        """Walk the chain for ``tokens[:prompt_len]``. Full pages match
        by exact chain key; a partial tail matches when one cached child
        covers the whole remaining prompt within its valid span; with a
        tier, a spilled page where the resident chain breaks restores and
        the walk goes on. Touches matched entries for LRU; counts no hit
        or miss (the engine does, once it knows whether the match is
        usable)."""
        ps = self.page_size
        prompt_len = int(prompt_len)
        key = self.root_key(weights_version)
        entries = []
        k = 0
        tick = next(self._tick)
        while (k + 1) * ps <= prompt_len:
            child_key = (
                key, tuple(int(t) for t in tokens[k * ps:(k + 1) * ps]))
            child = self._entries.get(child_key)
            if child is None and self._tier is not None:
                child = self._restore(child_key, key, weights_version,
                                      [e.page for e in entries])
            if child is None or not child.full:
                break
            child.last_hit = tick
            entries.append(child)
            key = child.key
            k += 1
        tail = None
        r = prompt_len - k * ps
        if 0 < r < ps:
            rest = tuple(int(t) for t in tokens[k * ps:prompt_len])
            for ck in self._children.get(key, ()):
                e = self._entries.get(ck)
                if e is None or e.valid_len < r:
                    continue
                if e.tokens[:r] == rest:
                    e.last_hit = tick
                    tail = e
                    break
            if tail is None and self._tier is not None:
                for ck in self._tier.children(key):
                    rec = self._tier.peek(ck)
                    if rec is None or rec.valid_len < r \
                            or rec.tokens[:r] != rest:
                        continue
                    e = self._restore(ck, key, weights_version,
                                      [x.page for x in entries])
                    if e is not None:
                        e.last_hit = tick
                        tail = e
                        break
        covered = k * ps + (r if tail is not None else 0)
        return PrefixMatch(entries, tail, covered)

    # -------------------------------------------------------- publishing
    def _add(self, key, parent, page, tokens, valid_len):
        e = PrefixEntry(key, parent, page, tokens, valid_len,
                        next(self._tick))
        self.pool.incref([page])
        self._entries[key] = e
        self._children.setdefault(parent, set()).add(key)
        if self._tier is not None and self._tier.peek(key) is not None:
            # a fresh publish supersedes a spilled copy of the key (one
            # whose restore once found no page): a later match must never
            # prefer the tier's bytes
            self._tier.pop(key)
        return e

    def publish(self, tokens, prompt_len, page_ids, weights_version):
        """Publish every full page of ``tokens[:prompt_len]`` whose chain
        position is not cached yet, from the request's own ``page_ids``
        (chain order). The cache takes one reference per page it
        publishes; an existing entry wins. Returns the number
        published."""
        ps = self.page_size
        prompt_len = int(prompt_len)
        key = self.root_key(weights_version)
        published = 0
        k = 0
        while (k + 1) * ps <= prompt_len and k < len(page_ids):
            toks = tuple(int(t) for t in tokens[k * ps:(k + 1) * ps])
            child_key = (key, toks)
            child = self._entries.get(child_key)
            if child is None:
                child = self._add(child_key, key, page_ids[k], toks, ps)
                published += 1
            key = child.key
            k += 1
        if published:
            self.update_gauges()
        return published

    def publish_partial(self, tokens, prompt_len, page_id,
                        weights_version):
        """Publish the partial last page of ``tokens[:prompt_len]`` (its
        ``prompt_len % page_size`` leading slots), once its owner can no
        longer write them, so a later request with the same prompt can
        adopt the whole of it. Only under a cached chain; an equal or
        longer cached tail wins."""
        ps = self.page_size
        prompt_len = int(prompt_len)
        r = prompt_len % ps
        if r == 0:
            return False
        k = prompt_len // ps
        key = self.root_key(weights_version)
        for i in range(k):
            child = self._entries.get(
                (key, tuple(int(t) for t in tokens[i * ps:(i + 1) * ps])))
            if child is None or not child.full:
                return False  # the chain below is not cached
            key = child.key
        rest = tuple(int(t) for t in tokens[k * ps:prompt_len])
        for ck in self._children.get(key, ()):
            e = self._entries.get(ck)
            if e is not None and e.valid_len >= r \
                    and e.tokens[:r] == rest:
                return False
        self._add((key, rest), key, page_id, rest, r)
        self.update_gauges()
        return True

    # ---------------------------------------------------------- eviction
    def _reclaimable(self, exclude=()):
        """Entry key -> whether an eviction pass could reclaim it: its
        page's one reference is the cache's, it is not in ``exclude``
        (the pages an admission is about to adopt) and every cached
        descendant is reclaimable. An iterative post-order walk (chains
        run one entry a page, past any recursion limit)."""
        exclude = set(exclude)
        out = {}
        for root in self._entries:
            if root in out:
                continue
            stack = [(root, False)]
            while stack:
                key, ready = stack.pop()
                if key in out:
                    continue
                kids = [ck for ck in self._children.get(key, ())
                        if ck in self._entries]
                if not ready:
                    stack.append((key, True))
                    stack.extend((ck, False) for ck in kids
                                 if ck not in out)
                    continue
                e = self._entries[key]
                out[key] = (
                    self.pool.refcount(e.page) == 1
                    and e.page not in exclude
                    and all(out.get(ck, False) for ck in kids)
                )
        return out

    def evictable_pages(self, exclude=()):
        """How many cached pages an eviction pass could reclaim now,
        ``exclude`` (pages the caller will adopt) left out: the
        engine's admission adds it to the free pages."""
        return sum(1 for v in self._reclaimable(exclude).values() if v)

    def _drop(self, entry):
        self._entries.pop(entry.key, None)
        kids = self._children.get(entry.parent)
        if kids is not None:
            kids.discard(entry.key)
            if not kids:
                self._children.pop(entry.parent, None)
        self._children.pop(entry.key, None)
        self.pool.release([entry.page])

    def evict(self, n_pages, exclude=()):
        """Reclaim up to ``n_pages`` cached pages, leaf-first in LRU
        order; a page some request still holds, or one in ``exclude``, is
        never touched. With a tier attached each victim's bytes spill
        there first (best effort: a refusal or a failed read degrades to
        plain eviction). Returns the number freed. Reclaimability is
        computed once a pass (a dropped leaf cannot change another
        entry's verdict); victims pop off a last-hit heap, a parent pushed
        when its last cached child goes."""
        ok = self._reclaimable(exclude)
        child_count = {
            key: sum(1 for ck in self._children.get(key, ())
                     if ck in self._entries)
            for key, good in ok.items() if good
        }
        # a unique tiebreaker: siblings matched in one walk share a tick,
        # and the nested-tuple keys do not order
        tie = itertools.count()
        heap = [(self._entries[key].last_hit, next(tie), key)
                for key, n in child_count.items() if n == 0]
        heapq.heapify(heap)
        freed = 0
        while freed < n_pages and heap:
            _, _, key = heapq.heappop(heap)
            victim = self._entries.get(key)
            if victim is None:
                continue
            parent = victim.parent
            if self._tier is not None and self._read_page is not None:
                try:
                    self._tier.put(
                        victim.key, victim.parent, victim.tokens,
                        victim.valid_len, self._read_page(victim.page),
                        weights_version=self._current_version())
                except Exception:
                    # a spill is best effort: the page frees either way,
                    # and the failure is counted
                    self._tier.dropped.inc(label="spill_error")
            self._drop(victim)
            freed += 1
            self.evictions.inc()
            if parent in child_count:
                child_count[parent] -= 1
                if child_count[parent] == 0:
                    heapq.heappush(heap, (self._entries[parent].last_hit,
                                          next(tie), parent))
        if freed:
            self.update_gauges()
        return freed

    def flush(self, reason="flush"):
        """Drop every entry and release the cache's references (a weight
        swap, and part of the engine's ``close``), and flush the tier
        under ``reason``. Returns the number of entries dropped."""
        n = len(self._entries)
        for e in list(self._entries.values()):
            self.pool.release([e.page])
        self._entries.clear()
        self._children.clear()
        if self._tier is not None:
            # spilled payloads go with the resident entries: after a
            # weight swap they could never pass the stale check
            self._tier.flush(reason=reason)
        if n:
            self.flushes += 1
        self.update_gauges()
        return n

    # -------------------------------------------------------- accounting
    @property
    def cached_pages(self):
        return len(self._entries)

    def hbm_saved_bytes(self):
        """Device bytes that sharing saves now: every reference past
        (cache + first holder) of a cached page is a private copy an
        engine without the cache would hold."""
        return self.pool.shared_saved_pages * self.pool.page_bytes()

    def update_gauges(self):
        self.hbm_saved.set(float(self.hbm_saved_bytes()))

    def stats(self):
        return {
            "entries": len(self._entries),
            "cached_pages": self.cached_pages,
            "hits": int(self.hits.value),
            "misses": int(self.misses.value),
            "evictions": int(self.evictions.value),
            "cow_clones": int(self.cow_clones.value),
            "tokens_saved": int(self.tokens_saved.value),
            "hbm_saved_bytes": int(self.hbm_saved_bytes()),
            "flushes": self.flushes,
            **({"tier": self._tier.stats()}
               if self._tier is not None else {}),
        }
