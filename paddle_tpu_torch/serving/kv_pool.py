"""Bucketed KV-cache pool for the serving engines (counterpart of
``paddle_tpu/serving/kv_pool.py``).

- **Blocks**: per-request prefill caches, their length rounded up to a
  power-of-two bucket, one block a bucket, reused by every request of
  the bucket. The buckets fix the prefill shapes to O(log S_max) of
  them, one captured prefill program each (``programs.py``), which is
  bound to its bucket's block. The engines admit one request at a time
  (alloc, prefill, adopt, free), so a second live block of a bucket is
  never needed: asking for one raises. Reused buffers are not zeroed: a
  slot is never read before it is written (stale values sit behind the
  -inf position mask).
- **Slabs**: the slab engine's resident decode buffer
  (``[num_slots, S_max, kvH, D]`` per layer x2), claimed slot by slot.
"""
from __future__ import annotations

from ..device import resolve_device
from ..models.generation import alloc_kv_caches, cache_torch_dtype


def bucket_for(seq_len, min_bucket=16, max_seq_len=None):
    """Smallest power of two >= seq_len (floored at ``min_bucket``,
    capped at ``max_seq_len``)."""
    if seq_len < 1:
        raise ValueError(f"seq_len must be >= 1, got {seq_len}")
    b = max(int(min_bucket), 1)
    while b < seq_len:
        b <<= 1
    if max_seq_len is not None:
        if seq_len > max_seq_len:
            raise ValueError(
                f"seq_len {seq_len} exceeds max_seq_len {max_seq_len}"
            )
        b = min(b, int(max_seq_len))
    return b


class KVBlock:
    """A bucketed per-request cache: ``caches`` is the
    ``alloc_kv_caches`` layout ([1, bucket, kvH, D] x2 per layer)."""

    __slots__ = ("bucket", "caches", "_live")

    def __init__(self, bucket, caches):
        self.bucket = bucket
        self.caches = caches
        self._live = True


class SlotSlab:
    """Claimable rows of an engine's decode slab; ``claim()`` returns a
    free row or None."""

    def __init__(self, num_slots, seq_len):
        self.num_slots = int(num_slots)
        self.seq_len = int(seq_len)
        self._free = list(range(int(num_slots)))[::-1]
        self._claimed = set()

    def claim(self):
        if not self._free:
            return None
        slot = self._free.pop()
        self._claimed.add(slot)
        return slot

    def release(self, slot):
        if slot not in self._claimed:
            raise ValueError(f"slot {slot} is not claimed (double free?)")
        self._claimed.remove(slot)
        self._free.append(slot)

    @property
    def claimed(self):
        return len(self._claimed)

    @property
    def free_slots(self):
        return len(self._free)


class KVCachePool:
    """Power-of-two prefill blocks, one a bucket, plus slot accounting
    for decode slabs. ``occupancy`` counts live blocks and claimed
    slots; a drained server reads 0."""

    def __init__(self, config, *, dtype=None, min_bucket=16,
                 max_seq_len=4096, device=None):
        self.config = config
        self.dtype = cache_torch_dtype(dtype)
        self.min_bucket = int(min_bucket)
        self.max_seq_len = int(max_seq_len)
        self.device = resolve_device(device)
        self._blocks = {}  # bucket -> its KVBlock
        self._live_blocks = 0
        self._slabs = []
        self._block_bytes = 0  # every block created (they stay resident)
        self._slab_bytes = 0
        self.allocs = 0
        self.reuse_hits = 0

    def bucket_for(self, seq_len):
        return bucket_for(seq_len, self.min_bucket, self.max_seq_len)

    def alloc(self, seq_len):
        """The KVBlock of the bucket that covers ``seq_len``; a
        RuntimeError while that block is live."""
        bucket = self.bucket_for(seq_len)
        blk = self._blocks.get(bucket)
        if blk is None:
            blk = self._blocks[bucket] = KVBlock(bucket, alloc_kv_caches(
                self.config, 1, bucket, self.dtype, device=self.device))
            self.allocs += 1
            self._block_bytes += _nbytes(blk.caches)
        elif blk._live:
            raise RuntimeError(
                f"the block of bucket {bucket} is live: the pool holds one "
                f"block a bucket (its captured prefill program is bound to "
                f"it)")
        else:
            self.reuse_hits += 1
        blk._live = True
        self._live_blocks += 1
        return blk

    def free(self, block):
        if not block._live:
            raise ValueError("KVBlock double-free")
        block._live = False
        self._live_blocks -= 1

    def alloc_slab_arrays(self, num_slots, seq_len):
        caches = alloc_kv_caches(self.config, num_slots, seq_len,
                                 self.dtype, device=self.device)
        self._slab_bytes += _nbytes(caches)
        return caches

    def register_slab(self, num_slots, seq_len):
        slab = SlotSlab(num_slots, seq_len)
        self._slabs.append(slab)
        return slab

    @property
    def occupancy(self):
        return self._live_blocks + sum(s.claimed for s in self._slabs)

    def stats(self):
        """JAX's pool readout (the ``/healthz`` ``pool`` block);
        ``reserved_bytes`` counts the tensors the pool allocated."""
        return {
            "dtype": str(self.dtype).replace("torch.", ""),
            "live_blocks": self._live_blocks,
            "free_blocks": len(self._blocks) - self._live_blocks,
            "claimed_slots": sum(s.claimed for s in self._slabs),
            "slab_slots": sum(s.num_slots for s in self._slabs),
            "occupancy": self.occupancy,
            "reserved_bytes": int(self._block_bytes + self._slab_bytes),
            "allocs": self.allocs,
            "reuse_hits": self.reuse_hits,
        }


def _nbytes(tensors):
    """Bytes of every tensor in a (nested) cache structure."""
    if isinstance(tensors, (list, tuple)):
        return sum(_nbytes(t) for t in tensors)
    if hasattr(tensors, "element_size"):
        return tensors.numel() * tensors.element_size()
    return _nbytes(tensors.q) + _nbytes(tensors.scale)  # QuantizedKV
