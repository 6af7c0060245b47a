"""The KV spill tier in the port (``paddle_tpu_torch/serving/
kv_tiering.py``, the frame codec ``serving/fleet/kv_transfer.py``, the
prefix cache's tier and the paged engine's spill and restore) against the
JAX package's, on the CPU.

The port's page frames are byte for byte JAX ``pack_page``'s for fp32,
bf16 and int8 pages, and each side unpacks the other's; damaged frames
(magic, length, CRC, header, leaves) are refused with JAX's messages;
``TieredPageStore`` equals JAX's on one script (host budget, moves to a
disk tier, restores, stale weights, CRC damage, flush). On a tiny paged
engine: a spilled-then-restored page is bit-equal to the page that
spilled (fp32, bf16, int8 arenas); a corrupt spill falls back to a cold
prefill whose stream stays exact; a full tier degrades to plain eviction;
turn 2 warm-hits turn 1's decode-written pages (JAX
``tests/test_sessions.py:267``); and in a full arena a restore spills a
colder page to make room. No JAX engine is built: the JAX side is its
pure-Python store and codec; streams are held against the port's
``generate``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from paddle_tpu.observability.registry import MetricsRegistry  # noqa: E402
from paddle_tpu.serving import TieredPageStore as JStore  # noqa: E402
from paddle_tpu.serving import TransferError as JTransferError  # noqa: E402
from paddle_tpu.serving import pack_page as j_pack  # noqa: E402
from paddle_tpu.serving import unpack_page as j_unpack  # noqa: E402
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM  # noqa
from paddle_tpu_torch.serving import (  # noqa: E402
    PagedServingEngine,
    TieredPageStore,
    TransferError,
    pack_page,
    unpack_page,
)
from paddle_tpu_torch.serving.fleet import kv_transfer as tkt  # noqa: E402
from test_torch_kernels import _one_thread  # noqa: E402,F401  (autouse)

CFG = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
           num_hidden_layers=2, num_attention_heads=4)
GEOM = dict(max_batch_size=2, max_seq_len=64, min_bucket=8, page_size=8)
META = {"weights_version": "v0", "valid_len": 7}


@pytest.fixture(scope="module")
def net():
    return LlamaForCausalLM(LlamaConfig.tiny(**CFG), device="cpu", seed=5)


def _page(dtype, seed=0):
    """One page's buffers (8 slots, 4 kv heads, D 8) as torch tensors and
    as the numpy arrays JAX holds (bf16 through its ml_dtypes type)."""
    r = np.random.RandomState(seed)
    if dtype == "int8":
        q = r.randint(-127, 128, (8, 4, 8)).astype(np.int8)
        sc = (r.rand(8, 4) * 0.02).astype(np.float32)
        return [torch.from_numpy(q), torch.from_numpy(sc)], [q, sc]
    a = r.randn(8, 4, 8).astype(np.float32)
    if dtype == "float32":
        return [torch.from_numpy(a), torch.from_numpy(a.copy())], [a, a]
    t = torch.from_numpy(a).to(torch.bfloat16)
    j = np.frombuffer(t.view(torch.int16).numpy().tobytes(),
                      dtype=jnp.bfloat16).reshape(t.shape)
    return [t, t.clone()], [j, j.copy()]


def _bytes(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.contiguous().numpy().tobytes()
    return np.asarray(x).tobytes()


# ------------------------------------------------------------ the frames
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_frames_byte_identical_to_jax(dtype):
    tarrs, jarrs = _page(dtype)
    frame = pack_page(tarrs, META)
    assert frame == j_pack(jarrs, META)
    meta, back = unpack_page(j_pack(jarrs, META))
    jmeta, jback = j_unpack(frame)
    assert meta == jmeta == META
    for t, b, j in zip(tarrs, back, jback):
        assert b.dtype == t.dtype and tuple(b.shape) == tuple(t.shape)
        assert _bytes(b) == _bytes(t) == _bytes(j)
        assert str(np.asarray(j).dtype) == str(t.dtype).split(".")[1]


def _crafted(header_json, blob=b""):
    """A frame with a valid CRC over ``header_json`` (raw bytes) and
    ``blob``."""
    import zlib

    payload = tkt._HLEN.pack(len(header_json)) + header_json + blob
    crc = zlib.crc32(payload) & 0xFFFFFFFF
    return tkt.MAGIC + tkt._HEAD.pack(len(payload), crc) + payload


def _damaged():
    frame = pack_page(_page("float32")[0], META)
    flipped = bytearray(frame)
    flipped[len(frame) // 2] ^= 0x40
    over = bytearray(_crafted(b"{}"))
    over[16:20] = tkt._HLEN.pack(1 << 20)
    import zlib

    over[12:16] = (zlib.crc32(bytes(over[16:])) & 0xFFFFFFFF).to_bytes(
        4, "big")
    return {
        "magic": b"JUNK" + frame[4:], "short": b"", "length": frame[:-3],
        "crc": bytes(flipped), "header_overrun": bytes(over),
        "header_json": _crafted(b"{not json"),
        "leaves_short": _crafted(
            b'{"leaves": [{"dtype": "float32", "shape": [2]}]}', b"abcd"),
        "leaves_extra": _crafted(
            b'{"leaves": [{"dtype": "float32", "shape": [1]}]}', b"abcdefgh"),
    }


@pytest.mark.parametrize("damage", sorted(_damaged()))
def test_damage_refused_as_jax_refuses(damage):
    frame = _damaged()[damage]
    with pytest.raises(JTransferError) as jexc:
        j_unpack(frame)
    with pytest.raises(TransferError) as texc:
        unpack_page(frame)
    if damage != "header_json":
        # the JSON parser's own message may differ by version
        assert str(texc.value) == str(jexc.value)


# ------------------------------------------------------------ the store
def test_tiered_store_equals_jax_on_one_script(tmp_path):
    """Both stores through one script, ``stats()`` equal after each call:
    three puts over a two-page host budget (the oldest moves to a disk
    file), the disk record restored bit for bit, a stale-weights refusal,
    a CRC refusal, a key spilled again, the children index, a flush."""
    fb = len(pack_page(_page("float32")[0], META))
    kw = dict(host_budget_bytes=2 * fb + 8)
    port = TieredPageStore(disk_dir=str(tmp_path / "port"), **kw)
    jax_ = JStore(disk_dir=str(tmp_path / "jax"), registry=MetricsRegistry(),
                  **kw)
    pages = {k: _page("float32", k) for k in range(4)}

    def both(op, *args, **kwargs):
        out = []
        for store, side in ((port, 0), (jax_, 1)):
            a = [x[side] if isinstance(x, tuple) and len(x) == 2
                 and isinstance(x[0], list) else x for x in args]
            out.append(getattr(store, op)(*a, **kwargs))
        assert port.stats() == jax_.stats(), op
        return out

    for k in range(3):
        assert both("put", ("k", k), "root", range(8), 8, pages[k],
                    "v0") == [True, True]
    assert port.stats()["pages"] == {"host": 2, "disk": 1}
    assert set(port.children("root")) == set(jax_.children("root"))
    got, jgot = both("get", ("k", 0), weights_version="v0")
    assert got[0].tier == jgot[0].tier == "disk"
    assert got[1] == jgot[1]
    assert [_bytes(t) for t in got[2]] == [_bytes(a) for a in jgot[2]] == [
        _bytes(a) for a in pages[0][1]]
    both("pop", ("k", 0), restored=True)
    assert both("get", ("k", 1), weights_version="v1") == [None, None]
    for store in (port, jax_):
        rec = store.peek(("k", 2))
        buf = bytearray(rec.frame)
        buf[len(buf) // 2] ^= 0x20
        rec.frame = bytes(buf)
    assert both("get", ("k", 2), weights_version="v0") == [None, None]
    both("put", ("k", 3), "root", range(8), 5, pages[3], "v0")
    both("put", ("k", 3), "root", range(8), 8, pages[3], "v0")
    assert port.stats()["crc_refused"] == port.stats()["stale_refused"] == 1
    assert both("flush", reason="swap") == [1, 1]
    assert port.stats()["pages"] == {"host": 0, "disk": 0}
    tiny = [TieredPageStore(host_budget_bytes=1),
            JStore(host_budget_bytes=1, registry=MetricsRegistry())]
    assert [s.put(("k", 0), "root", range(8), 8, p, "v0") for s, p in
            zip(tiny, pages[0])] == [False, False]
    assert tiny[0].stats() == tiny[1].stats()


# ------------------------------------------------------- on an engine
def _tier_engine(net, cache="float32", num_pages=None, **tier):
    return PagedServingEngine(net, cache_dtype=cache, prefix_cache=True,
                              num_pages=num_pages,
                              kv_tiering=tier or True, **GEOM)


def _leaves(eng, page):
    return [t[page].clone() for t in eng._page_leaves(eng._caches)]


def _ref(net, prompt, n, cache="float32"):
    out = net.generate(np.asarray(prompt)[None], max_new_tokens=n,
                       cache_dtype=cache)
    return [int(t) for t in out[0, len(prompt):]]


def _drained(eng):
    eng.close()
    st = eng.page_pool.stats()
    assert st["pages_in_use"] == 0 and st["claims"] == st["releases"], st


@pytest.mark.parametrize("cache", ["float32", "bfloat16", "int8"])
def test_spilled_then_restored_page_is_bit_equal(net, cache):
    eng = _tier_engine(net, cache)
    pc, tier = eng.prefix_cache, eng.kv_tier
    prompt = np.random.RandomState(3).randint(0, 64, (20,))
    (h,) = eng.generate([prompt], max_new_tokens=5)
    toks, valid = h.output_ids, 24
    m = pc.match(toks, valid, eng.weights_version)
    assert m.covered == valid and len(m.pages) == 3
    before = [_leaves(eng, p) for p in m.pages]
    assert pc.evict(100) == 3 and eng.page_pool.pages_in_use == 0
    assert tier.stats()["pages"]["host"] == 3
    m = pc.match(toks, valid, eng.weights_version)
    assert m.covered == valid
    assert tier.stats()["restores"] == {"host": 3}
    for page, want in zip(m.pages, before):
        assert all(torch.equal(a, b) for a, b in zip(_leaves(eng, page),
                                                     want))
        assert eng.page_pool.refcount(page) == 1  # the cache's own
    (h2,) = eng.generate([toks[:22]], max_new_tokens=3)
    assert pc.stats()["hits"] == 1
    if cache == "float32":
        assert h2.tokens == _ref(net, toks[:22], 3)
    _drained(eng)


def test_corrupt_spill_falls_back_to_exact_cold_prefill(net):
    eng = _tier_engine(net)
    tier = eng.kv_tier
    prompt = np.random.RandomState(4).randint(0, 64, (16,))
    (h1,) = eng.generate([prompt], max_new_tokens=3)
    eng.prefix_cache.evict(10_000)
    assert sum(tier.stats()["pages"].values()) >= 2
    for rec in tier.iter_records():
        buf = bytearray(rec.frame)
        buf[len(buf) // 2] ^= 0x11
        rec.frame = bytes(buf)
    (h2,) = eng.generate([prompt], max_new_tokens=3)
    assert tier.stats()["crc_refused"] >= 1
    assert eng.prefix_cache.stats()["misses"] == 2
    assert h2.tokens == h1.tokens == _ref(net, prompt, 3)
    _drained(eng)


def test_full_tier_degrades_to_plain_eviction(net):
    eng = _tier_engine(net, host_budget_bytes=1)
    pc, tier = eng.prefix_cache, eng.kv_tier
    prompt = np.random.RandomState(5).randint(0, 64, (16,))
    eng.generate([prompt], max_new_tokens=3)
    n = pc.cached_pages
    assert pc.evict(100) == n and eng.page_pool.pages_in_use == 0
    assert tier.stats()["dropped"] == n and tier.stats()["pages"] == {
        "host": 0, "disk": 0}
    assert pc.match(prompt, 16, eng.weights_version).covered == 0
    (h,) = eng.generate([prompt], max_new_tokens=3)
    assert h.tokens == _ref(net, prompt, 3)
    _drained(eng)


def test_turn2_warm_hits_decode_written_pages(net):
    """Turn 2 of a conversation reuses more than turn 1's prompt: the
    decode-written answer pages published at finish are adopted too."""
    eng = PagedServingEngine(net, cache_dtype="float32", prefix_cache=True,
                             kv_tiering=True, sessions=True, **GEOM)
    rng = np.random.RandomState(29)
    prompt1 = rng.randint(0, 64, (12,))
    h1 = eng.submit(prompt1, 5, session_id="chat")
    eng.run_until_idle()
    s = eng.sessions.get("chat")
    assert s.turns == 1 and s.tokens == tuple(int(t) for t in h1.output_ids)
    p2 = np.asarray(list(s.tokens) + list(rng.randint(0, 64, (3,))))
    h2 = eng.submit(p2, 3, session_id="chat")
    eng.run_until_idle()
    # 16 of turn 1's 16 written positions (two full pages) are reused:
    # more than its 12-token prompt
    assert eng.prefix_cache.stats()["tokens_saved"] == 16 > len(prompt1)
    assert h2.tokens == _ref(net, p2, 3)
    assert eng.sessions.get("chat").turns == 2
    _drained(eng)


def test_restore_in_a_full_arena_spills_a_colder_page(net):
    """The port's departure from the JAX store: with no free page, a
    restore spills one colder cached page outside the walk and restores
    (the JAX store leaves the record spilled). Two conversations over an
    arena of 4 pages: the second spills two of the first's three pages,
    the first's next turn restores one with no free page, and the streams
    stay
    exact."""
    eng = _tier_engine(net, num_pages=4)
    pc, pool, tier = eng.prefix_cache, eng.page_pool, eng.kv_tier
    rng = np.random.RandomState(8)
    a, b = rng.randint(0, 64, (17,)), rng.randint(0, 64, (17,))
    (ha,) = eng.generate([a], max_new_tokens=7)
    (hb,) = eng.generate([b], max_new_tokens=7)
    assert tier.stats()["spills"]["host"] >= 2 and pool.free_pages == 0
    a2 = np.concatenate([ha.output_ids, [1, 2]])
    (ha2,) = eng.generate([a2], max_new_tokens=5)
    assert tier.stats()["restores"] == {"host": 1}
    assert pc.stats()["hits"] == 1 and pc.stats()["tokens_saved"] >= 16
    assert ha.tokens == _ref(net, a, 7) and hb.tokens == _ref(net, b, 7)
    assert ha2.tokens == _ref(net, a2, 5)
    _drained(eng)
