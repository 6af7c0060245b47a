"""The KV spill tier: cold prefix pages spill below the device instead of
dying (counterpart of ``paddle_tpu/serving/kv_tiering.py``).

Without a tier, the prefix cache (``prefix_cache.PrefixCache``) evicts a
cold page outright, and the next turn of that conversation prefills
again everything the page held. With one attached:

- **host tier**: a store of spilled pages in process RAM under a byte
  budget. ``PrefixCache.evict`` reads the victim page's arena bytes and
  ``put``s them here before the page frees (the same leaf-first LRU
  victims: spill replaces outright eviction);
- **disk tier** (optional): when the host budget overflows, the coldest
  host payloads move to files under ``disk_dir`` instead of being
  dropped (the frame, CRC included, is the file's content).

Every spilled page is one CRC-checked frame of the KV wire format
(``fleet/kv_transfer.py``: ``MAGIC | len | crc32 | header_json | raw
leaf bytes``), byte for byte the JAX package's frame of the same page.
A payload damaged anywhere (RAM, a truncated file, another version) is
refused at restore and the request falls back to a cold prefill, which
is counted: the tier saves prefill work and never decides a stream. A
restore also refuses a payload whose recorded ``weights_version`` is
not the requesting engine's.

The counters and gauges register in the process registry (or
``registry=``) under JAX's names, and the store notes JAX's
flight-recorder events (``kv_spill``, ``kv_demote``, ``kv_restore``,
``kv_restore_refused``) in the process recorder (or ``recorder=``).
Driven from the engine's loop only, like the cache that owns it.
"""
from __future__ import annotations

import json
import os
import zlib
from collections import OrderedDict

import numpy as np

from .fleet.kv_transfer import (
    MAGIC,
    MAX_FRAME_BYTES,
    TransferError,
    _decode_array,
    _encode_array,
    _HEAD,
    _HLEN,
    _itemsize,
)
from ..observability import get_flight_recorder, get_registry
from .metrics import Counter, Gauge

TIER_HOST = "host"
TIER_DISK = "disk"


# ------------------------------------------------------------------ frames
def pack_page(arrays, meta):
    """One spilled page as a self-checking frame: ``meta`` (a small JSON
    dict: weights_version, valid_len) and every array of the page (torch
    tensors or numpy), concatenated raw."""
    headers, parts = [], []
    for a in arrays:
        h, b = _encode_array(a)
        headers.append(h)
        parts.append(b)
    header = dict(meta)
    header["kind"] = "kv_page"
    header["leaves"] = headers
    hj = json.dumps(header).encode("utf-8")
    payload = _HLEN.pack(len(hj)) + hj + b"".join(parts)
    crc = zlib.crc32(payload) & 0xFFFFFFFF
    return MAGIC + _HEAD.pack(len(payload), crc) + payload


def unpack_page(frame):
    """Decode and check one spilled-page frame -> ``(meta, arrays)``, the
    arrays as CPU torch tensors. Raises
    :class:`~.fleet.kv_transfer.TransferError` on any damage (magic,
    length, CRC, header, leaf sizes)."""
    if len(frame) < 4 + _HEAD.size or frame[:4] != MAGIC:
        raise TransferError("bad spilled-page magic")
    length, crc = _HEAD.unpack(frame[4:4 + _HEAD.size])
    payload = frame[4 + _HEAD.size:]
    if length != len(payload) or length > MAX_FRAME_BYTES:
        raise TransferError(
            f"spilled-page length {length} != payload {len(payload)}"
        )
    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
        raise TransferError("spilled-page CRC mismatch")
    hlen = _HLEN.unpack(payload[:_HLEN.size])[0]
    if _HLEN.size + hlen > length:
        raise TransferError("spilled-page header overruns payload")
    try:
        header = json.loads(
            payload[_HLEN.size:_HLEN.size + hlen].decode("utf-8")
        )
    except Exception as e:
        raise TransferError(f"bad spilled-page header: {e!r}")
    blob = payload[_HLEN.size + hlen:]
    arrays, off = [], 0
    for h in header.get("leaves", ()):
        n = int(np.prod(h["shape"])) * _itemsize(h["dtype"])
        arrays.append(_decode_array(h, blob[off:off + n]))
        off += n
    if off != len(blob):
        raise TransferError(
            f"spilled-page leaves cover {off}B != blob {len(blob)}B"
        )
    meta = {k: v for k, v in header.items()
            if k not in ("kind", "leaves")}
    return meta, arrays


class _Spilled:
    """One spilled page record. ``frame`` holds the bytes while the
    record sits in the host tier; a record moved to disk holds ``path``
    instead (the frame is the file's content)."""

    __slots__ = ("key", "parent", "tokens", "valid_len",
                 "weights_version", "frame", "path", "nbytes", "tier")

    def __init__(self, key, parent, tokens, valid_len,
                 weights_version, frame):
        self.key = key
        self.parent = parent
        self.tokens = tuple(int(t) for t in tokens)
        self.valid_len = int(valid_len)
        self.weights_version = str(weights_version)
        self.frame = frame
        self.path = None
        self.nbytes = len(frame)
        self.tier = TIER_HOST


class TieredPageStore:
    """Bounded spill store for prefix pages whose only reference was the
    cache's.

    ``put`` admits a packed page under the host byte budget, moving the
    coldest records to disk (when ``disk_dir`` is set) or dropping them
    (counted: a full tier degrades to plain eviction, never an error).
    ``get`` returns ``(record, meta, arrays)`` after checking the frame,
    or None with the refusal counted. Keys are the prefix cache's chain
    keys, so the parent index serves the same partial-tail search
    ``match`` runs over resident entries."""

    def __init__(self, *, host_budget_bytes=64 << 20, disk_dir=None,
                 disk_budget_bytes=None, registry=None,
                 namespace="paddle_serving", recorder=None):
        self.host_budget_bytes = int(host_budget_bytes)
        self.disk_dir = disk_dir
        self.disk_budget_bytes = (
            None if disk_budget_bytes is None else int(disk_budget_bytes)
        )
        if disk_dir is not None:
            os.makedirs(disk_dir, exist_ok=True)
        self._records = OrderedDict()   # key -> _Spilled, LRU order
        self._children = {}             # parent -> set of keys
        self._bytes = {TIER_HOST: 0, TIER_DISK: 0}
        self._file_seq = 0
        self._rec = recorder if recorder is not None \
            else get_flight_recorder()
        ns = namespace
        self.tier_pages = Gauge(
            "kv_tier_pages", prom_name=f"{ns}_kv_tier_pages",
            help="spilled prefix pages resident per tier")
        self.tier_bytes = Gauge(
            "kv_tier_bytes", prom_name=f"{ns}_kv_tier_bytes",
            help="spilled payload bytes resident per tier")
        self.spills = Counter(
            "kv_tier_spills", labelname="tier",
            prom_name=f"{ns}_kv_tier_spills_total",
            help="prefix pages spilled into a tier (host admit, disk "
                 "demote)")
        self.restores = Counter(
            "kv_tier_restores", labelname="tier",
            prom_name=f"{ns}_kv_tier_restores_total",
            help="spilled pages restored into the HBM arena, by "
                 "source tier")
        self.crc_refused = Counter(
            "kv_tier_crc_refused",
            prom_name=f"{ns}_kv_tier_crc_refused_total",
            help="spilled pages REFUSED at restore: frame damage "
                 "(magic/length/CRC/header) — request falls back to "
                 "cold prefill")
        self.stale_refused = Counter(
            "kv_tier_stale_refused",
            prom_name=f"{ns}_kv_tier_stale_refused_total",
            help="spilled pages REFUSED at restore: weights_version "
                 "mismatch")
        self.dropped = Counter(
            "kv_tier_dropped", labelname="reason",
            prom_name=f"{ns}_kv_tier_dropped_total",
            help="spilled pages dropped without restore (budget "
                 "pressure, flush, damage)")
        (registry or get_registry()).register_all([
            self.tier_pages, self.tier_bytes, self.spills,
            self.restores, self.crc_refused, self.stale_refused,
            self.dropped,
        ])
        self._update_gauges()

    # ------------------------------------------------------------ admit
    def put(self, key, parent, tokens, valid_len, arrays,
            weights_version):
        """Spill one page. True when the payload is held below the device
        afterwards; False when it cannot fit (the caller evicts
        outright)."""
        frame = pack_page(
            arrays,
            {"weights_version": str(weights_version),
             "valid_len": int(valid_len)},
        )
        old = self._records.pop(key, None)
        if old is not None:
            self._discard(old, count=False)
        rec = _Spilled(key, parent, tokens, valid_len,
                       weights_version, frame)
        # make room: move (or drop) the coldest host records first
        while (self._bytes[TIER_HOST] + rec.nbytes
               > self.host_budget_bytes):
            victim = self._oldest(TIER_HOST)
            if victim is None:
                break
            if not self._demote(victim):
                self._records.pop(victim.key, None)
                self._discard(victim)
        if self._bytes[TIER_HOST] + rec.nbytes <= self.host_budget_bytes:
            self._records[key] = rec
            self._children.setdefault(parent, set()).add(key)
            self._bytes[TIER_HOST] += rec.nbytes
            self.spills.inc(label=TIER_HOST)
            self._rec.note("kv_spill", tier=TIER_HOST, bytes=rec.nbytes,
                           tokens=len(rec.tokens))
            self._update_gauges()
            return True
        # the host cannot hold it even after moving records (a payload
        # larger than the whole budget, or nothing left to move): straight
        # to disk when there is one
        self._records[key] = rec
        self._children.setdefault(parent, set()).add(key)
        self._bytes[TIER_HOST] += rec.nbytes  # _demote rebalances
        if self._demote(rec):
            self._update_gauges()
            return True
        self._bytes[TIER_HOST] -= rec.nbytes
        self._records.pop(key, None)
        kids = self._children.get(parent)
        if kids is not None:
            kids.discard(key)
            if not kids:
                self._children.pop(parent, None)
        self.dropped.inc(label="budget")
        self._update_gauges()
        return False

    def _disk_ok(self, nbytes):
        if self.disk_dir is None:
            return False
        return (self.disk_budget_bytes is None
                or self._bytes[TIER_DISK] + nbytes
                <= self.disk_budget_bytes)

    def _oldest(self, tier):
        for rec in self._records.values():
            if rec.tier == tier:
                return rec
        return None

    def _demote(self, rec):
        """Move one host record's payload to a file; False when there is
        no disk or it is over budget (the caller drops the record)."""
        if not self._disk_ok(rec.nbytes):
            return False
        self._file_seq += 1
        path = os.path.join(self.disk_dir,
                            f"kvpage-{self._file_seq:08d}.pkv")
        try:
            with open(path, "wb") as f:
                f.write(rec.frame)
        except OSError:
            return False
        self._bytes[TIER_HOST] -= rec.nbytes
        self._bytes[TIER_DISK] += rec.nbytes
        rec.frame = None
        rec.path = path
        rec.tier = TIER_DISK
        self.spills.inc(label=TIER_DISK)
        self._rec.note("kv_demote", tier=TIER_DISK, bytes=rec.nbytes)
        # the record keeps its LRU place: a move is not a touch
        return True

    # ------------------------------------------------------------ lookup
    def children(self, parent):
        """Spilled chain keys under ``parent``: the tail search of
        ``PrefixCache.match`` reads these beside its resident
        children."""
        return tuple(self._children.get(parent, ()))

    def peek(self, key):
        return self._records.get(key)

    def iter_records(self):
        """Resident spill records, coldest first (read-only)."""
        return tuple(self._records.values())

    def _refuse(self, rec, counter, **note):
        counter.inc()
        if note:
            self._rec.note("kv_restore_refused", **note)
        self._records.pop(rec.key, None)
        self._discard(rec)
        self._update_gauges()

    def get(self, key, weights_version=None):
        """Fetch and check one spilled page: ``(record, meta, arrays)``,
        or None (absent, stale or damaged: the refusal counted, the
        record dropped, the caller prefills cold). A healthy record
        stays: the caller pops it once the restore has landed."""
        rec = self._records.get(key)
        if rec is None:
            return None
        if weights_version is not None \
                and rec.weights_version != str(weights_version):
            self._refuse(rec, self.stale_refused, reason="stale_weights")
            return None
        frame = rec.frame
        if frame is None and rec.path is not None:
            try:
                with open(rec.path, "rb") as f:
                    frame = f.read()
            except OSError:
                frame = b""
        try:
            meta, arrays = unpack_page(frame)
        except TransferError:
            self._refuse(rec, self.crc_refused, reason="frame_damage",
                         tier=rec.tier)
            return None
        if weights_version is not None and str(
                meta.get("weights_version")) != str(weights_version):
            # the header says stale where the record did not
            self._refuse(rec, self.stale_refused)
            return None
        self._records.move_to_end(key)
        return rec, meta, arrays

    def pop(self, key, restored=False):
        """Remove one record (after a restore landed, or to drop it);
        counts a restore when ``restored``."""
        rec = self._records.pop(key, None)
        if rec is None:
            return
        if restored:
            self.restores.inc(label=rec.tier)
            self._rec.note("kv_restore", tier=rec.tier,
                           bytes=rec.nbytes, tokens=len(rec.tokens))
            self._discard(rec, count=False)
        else:
            self._discard(rec)
        self._update_gauges()

    def _discard(self, rec, count=True):
        self._bytes[rec.tier] -= rec.nbytes
        kids = self._children.get(rec.parent)
        if kids is not None:
            kids.discard(rec.key)
            if not kids:
                self._children.pop(rec.parent, None)
        if rec.path is not None:
            try:
                os.unlink(rec.path)
            except OSError:
                pass
        if count:
            self.dropped.inc(label="evicted")

    def flush(self, reason="flush"):
        """Drop every record (a weight swap, whose pages could never
        restore, and the engine's close). Returns how many."""
        n = len(self._records)
        for rec in list(self._records.values()):
            self._discard(rec, count=False)
        if n:
            self.dropped.inc(n, label=reason)
        self._records.clear()
        self._children.clear()
        self._update_gauges()
        return n

    # -------------------------------------------------------- accounting
    def _update_gauges(self):
        for tier in (TIER_HOST, TIER_DISK):
            self.tier_pages.set(
                float(sum(1 for r in self._records.values()
                          if r.tier == tier)), tier=tier)
            self.tier_bytes.set(float(self._bytes[tier]), tier=tier)

    def stats(self):
        host = sum(1 for r in self._records.values()
                   if r.tier == TIER_HOST)
        return {
            "pages": {TIER_HOST: host,
                      TIER_DISK: len(self._records) - host},
            "bytes": dict(self._bytes),
            "host_budget_bytes": self.host_budget_bytes,
            "spills": self.spills.by_label(),
            "restores": self.restores.by_label(),
            "crc_refused": int(self.crc_refused.value),
            "stale_refused": int(self.stale_refused.value),
            "dropped": int(self.dropped.value),
        }
