"""The port's fleet tier (``paddle_tpu_torch/serving/fleet/``) against the
JAX package's, on tiny fp32 models on 127.0.0.1.

- frames: the port's ``send_frame`` writes JAX's bytes for the same
  header and blob (arrays in fp32, bf16 and int8 too), each package reads
  the other's frames and a PKV1 frame; bad magic, a short read and a CRC
  mismatch raise ``TransferError``;
- remote prefill: in fp32, bf16 and int8 the arena after a remote
  prefill is bit-identical to a local prefill's, and the greedy fp32
  streams equal JAX ``generate`` (weights carried by ``convert.py``); a
  port client adopts from a JAX ``PrefillWorker`` and a JAX client from a
  port worker; a dead worker costs exactly one fallback and opens the
  cooldown, a version skew falls back, a sampled stream through the
  transport equals the one without, and the prefill spans say which;
- placement: ``FleetRouter._pick`` chooses what JAX's chooses over a
  seeded table of scraped statuses, in-flight counts, breakers and
  affinity keys (neither router started);
- the router over two tiny port replicas behind ``ServingFrontend``s:
  streams equal the direct streams and JAX ``generate`` and spread over
  both replicas, a session's turns stick to one replica, an unstarted
  request retries past a dead replica, a mid-stream death ends
  ``replica_failed``, 429 ``fleet_saturated`` before any stream and 503
  ``no_replicas``, ``/admin/drain`` with no dropped stream, and the
  rolling ``/admin/reload`` walk;
- launch: a ``spawn("prefill", ["--device", "cpu"])`` child serves the
  prefill of an in-process worker over the same seeded weights, and
  exits 0 on SIGTERM.

Every socket, HTTP and join wait has a timeout; placement-sensitive legs
scrape synchronously or hold the replicas' front-end locks instead of
waiting on time.
"""
import copy
import http.client
import http.server
import json
import socket
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.core.tensor import Tensor  # noqa: E402
from paddle_tpu.models import LlamaConfig as JConfig  # noqa: E402
from paddle_tpu.models import LlamaForCausalLM as JLlama  # noqa: E402
from paddle_tpu.observability import MetricsRegistry as JRegistry  # noqa
from paddle_tpu.serving import PagedServingEngine as JEngine  # noqa: E402
from paddle_tpu.serving.fleet import kv_transfer as jkt  # noqa: E402
from paddle_tpu.serving.fleet.router import FleetRouter as JRouter  # noqa
from paddle_tpu_torch import chaos as tchaos  # noqa: E402
from paddle_tpu_torch import observability as obs  # noqa: E402
from paddle_tpu_torch.chaos import ChaosClock  # noqa: E402
from paddle_tpu_torch.checkpoint import CheckpointManager  # noqa: E402
from paddle_tpu_torch.convert import load_numpy_state  # noqa: E402
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM  # noqa
from paddle_tpu_torch.quantization import quantize_for_serving  # noqa
from paddle_tpu_torch.serving import (  # noqa: E402
    FleetRouter,
    HTTPRejected,
    PagedServingEngine,
    PrefillWorker,
    RemotePrefillClient,
    ServingFrontend,
    TransferError,
    stream_generate,
)
from paddle_tpu_torch.serving.fleet import kv_transfer as tkt  # noqa: E402
from paddle_tpu_torch.serving.fleet import launch  # noqa: E402
from test_torch_kernels import _one_thread  # noqa: E402,F401  (autouse)

CFG = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
           num_hidden_layers=2, num_attention_heads=4)
KW = dict(max_batch_size=2, max_seq_len=64, min_bucket=8, page_size=8)
RNG = np.random.RandomState(13)
TIMEOUT = 60
# the prompts whose streams are held against JAX ``generate``: one batched
# call gives every reference (a greedy stream's first k tokens are the
# k-token stream)
PROMPTS = [[int(t) for t in RNG.randint(0, 64, (6,))] for _ in range(8)]
NEW = 6


CHILD_CLI = ["--device", "cpu", "--seed", "11"]


@pytest.fixture(scope="module", autouse=True)
def _prefill_child():
    """The launched prefill worker of the launch test, started with the
    module so that its interpreter starts while the JAX references
    compile; killed at the end of the module if the test did not stop
    it."""
    proc, lines = launch._popen("prefill", CHILD_CLI,
                                {"OMP_NUM_THREADS": "1"})
    yield proc, lines
    if proc.poll() is None:
        proc.kill()
        proc.wait(TIMEOUT)


@pytest.fixture(scope="module")
def nets():
    """The JAX net, its weights as numpy arrays, and JAX ``generate``'s
    streams of PROMPTS (fp32 cache)."""
    paddle.seed(5)
    jnet = JLlama(JConfig.tiny(**CFG))
    jnet.eval()
    arrays = {k: np.asarray(p.value) for k, p in jnet.named_parameters()}
    ids = np.asarray(PROMPTS, np.int32)
    out = np.asarray(jnet.generate(Tensor(jnp.asarray(ids)),
                                   max_new_tokens=NEW,
                                   cache_dtype="float32").numpy())
    refs = [[int(t) for t in row[ids.shape[1]:]] for row in out]
    return jnet, arrays, refs


def _tnet(arrays):
    """A port net of its own over the JAX weights."""
    net = LlamaForCausalLM(LlamaConfig.tiny(**CFG), device="cpu")
    load_numpy_state(net, arrays)
    return net.eval()


def _engine(net, **kw):
    return PagedServingEngine(net, **{**KW, "cache_dtype": "float32", **kw})


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _leaves(eng):
    return eng._page_leaves(eng._caches)


def _stop_jax_worker(w):
    # a close alone leaves the JAX worker's accept() blocked until its
    # join times out: a shutdown wakes it
    try:
        w._listener.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    w.stop()


def _tokens(events):
    assert events[-1][0] == "done", events[-1]
    return [d["token"] for e, d in events if e == "token"]


def _stream(port, ids, new, **extra):
    return stream_generate("127.0.0.1", port,
                           dict({"input_ids": [int(t) for t in ids],
                                 "max_new_tokens": new}, **extra),
                           timeout=TIMEOUT)[0]


def _http(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request(method, path,
                     body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def _join(threads):
    for t in threads:
        t.join(TIMEOUT)
        assert not t.is_alive()


# ------------------------------------------------------------------ frames
class _Buf:
    """Just enough socket to capture what send_frame writes."""

    def __init__(self):
        self.data = b""

    def sendall(self, b):
        self.data += bytes(b)


def _frame(mod, header, blob=b""):
    buf = _Buf()
    mod.send_frame(buf, header, blob)
    return buf.data


def _recv(mod, data):
    a, b = socket.socketpair()
    try:
        a.sendall(data)
        a.close()
        b.settimeout(TIMEOUT)
        h, blob = mod.recv_frame(b)
        return h, bytes(blob)
    finally:
        b.close()


def test_frames_are_jax_bytes():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 8, 2, 4).astype(np.float32)
    arrays = [
        (x, torch.from_numpy(x)),
        (x.astype(ml_dtypes.bfloat16), torch.from_numpy(x).bfloat16()),
        (rng.randint(-127, 128, (3, 8, 2)).astype(np.int8), None),
    ]
    frames = [({"kind": "x", "n": 3}, bytes(range(256)) * 17),
              ({"kind": "prefilled", "first_token": 5, "entries": 4}, b"")]
    for j, t in arrays:
        t = torch.from_numpy(j) if t is None else t
        jh, jb = jkt._encode_array(j)
        th, tb = tkt._encode_array(t)
        assert (th, tb) == (jh, jb)
        frames.append((dict(th, part="dense"), tb))
        back = tkt._decode_array(jh, jb)
        assert back.dtype == t.dtype and torch.equal(back, t)
    for header, blob in frames:
        data = _frame(tkt, header, blob)
        assert data == _frame(jkt, header, blob)
        assert _recv(jkt, data) == (header, blob)
        assert _recv(tkt, data) == (header, blob)
        # a PKV1 peer's frame: the same layout under the old magic
        assert _recv(tkt, b"PKV1" + data[4:]) == (header, blob)


def test_damaged_frames_raise_transfer_error():
    blob = bytes(range(256)) * 17
    bad = bytearray(_frame(tkt, {"kind": "y"}, blob))
    bad[-1] ^= 0xFF
    with pytest.raises(TransferError, match="CRC"):
        _recv(tkt, bytes(bad))
    with pytest.raises(TransferError, match="closed mid-frame"):
        _recv(tkt, _frame(tkt, {"kind": "z"}, blob)[:200])
    with pytest.raises(TransferError, match="magic"):
        _recv(tkt, b"NOPE" + b"\x00" * 12)


# --------------------------------------------------------- remote prefill
@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16", "int8"])
def test_remote_prefill_arena_is_bit_identical(nets, cache_dtype):
    """After the same admission the disaggregated engine's arena equals
    the local engine's bit for bit, codes and scales alike; the streams
    are equal, and in fp32 equal JAX ``generate``."""
    _, arrays, refs = nets
    net = _tnet(arrays)
    if cache_dtype == "int8":
        net = quantize_for_serving(copy.deepcopy(net), inplace=True)
    worker = PrefillWorker(net, weights_version="wv1").start()
    try:
        client = RemotePrefillClient("127.0.0.1", worker.port,
                                     expected_weights_version="wv1")
        local = _engine(net, cache_dtype=cache_dtype)
        disagg = _engine(net, cache_dtype=cache_dtype,
                         weights_version="wv1", prefill_transport=client)
        prompts = [PROMPTS[0], [int(t) for t in RNG.randint(0, 64, (13,))],
                   PROMPTS[1]]
        hl = [local.submit(prompts[0], 4)]
        hd = [disagg.submit(prompts[0], 4)]
        local.step()
        disagg.step()
        assert (disagg.remote_prefills, disagg.local_prefills) == (1, 0)
        for a, b in zip(_leaves(local), _leaves(disagg)):
            assert a.dtype == b.dtype and torch.equal(a, b)
        hl += [local.submit(p, 5) for p in prompts[1:]]
        hd += [disagg.submit(p, 5) for p in prompts[1:]]
        local.run_until_idle()
        disagg.run_until_idle()
        assert [h.tokens for h in hd] == [h.tokens for h in hl]
        if cache_dtype == "float32":
            assert [hd[0].tokens, hd[2].tokens] == [refs[0][:4],
                                                    refs[1][:5]]
        assert disagg.remote_prefills == 3 and worker.served == 3
        assert disagg.page_pool.pages_in_use == 0
        assert client.transfers.by_label() == {"ok": 3}
        disagg.close()
    finally:
        worker.stop()
    assert not worker._conns


def test_worker_keeps_each_prefills_pages(nets):
    """Two prefills of one bucket at once: the first connection is held at
    its first page frame (the ``kv.send_frame`` seam) until the second
    prefill has rewritten the worker's block; each client still receives
    its own pages, equal to its prefill alone."""
    _, arrays, _ = nets
    worker = PrefillWorker(_tnet(arrays)).start()

    def prefill(p):
        c = RemotePrefillClient("127.0.0.1", worker.port, timeout_s=TIMEOUT)
        try:
            return c.prefill(p, len(p), 8, 8, "float32", 1.0, None)
        finally:
            c.close()

    try:
        prompts = PROMPTS[:2]
        alone = [prefill(p) for p in prompts]
        seen = {"prefilled": 0, "dense": 0}
        lock = threading.Lock()
        second_sent = threading.Event()
        held = threading.Event()

        def hold(kind=None, **_):
            with lock:
                if kind in seen:
                    seen[kind] += 1
                n = dict(seen)
            if kind == "prefilled" and n["prefilled"] == 2:
                second_sent.set()
            if kind == "dense" and n["dense"] == 1:
                held.set()
                assert second_sent.wait(TIMEOUT)

        out = [None, None]
        with tchaos.chaos() as m:
            m.on("kv.send_frame", hold)
            th = threading.Thread(
                target=lambda: out.__setitem__(0, prefill(prompts[0])))
            th.start()
            assert held.wait(TIMEOUT)
            out[1] = prefill(prompts[1])
            _join([th])
        for (t_got, got), (t_want, want) in zip(out, alone):
            assert t_got == t_want
            assert all(torch.equal(a, b) for a, b in zip(got, want))
    finally:
        worker.stop()


def test_cross_package_wire(nets):
    """A port client adopts from a JAX worker, and a JAX client from a
    port worker: both streams equal JAX ``generate``."""
    jnet, arrays, refs = nets
    ids = [PROMPTS[2]]
    want = refs[2][:5]
    jw = jkt.PrefillWorker(jnet).start()
    try:
        eng = _engine(_tnet(arrays), prefill_transport=RemotePrefillClient(
            "127.0.0.1", jw.port))
        h = eng.submit(ids, 5)
        eng.run_until_idle()
        assert (eng.remote_prefills, eng.local_prefills) == (1, 0)
        assert h.tokens == want
        eng.close()
    finally:
        _stop_jax_worker(jw)
    tw = PrefillWorker(_tnet(arrays)).start()
    try:
        jeng = JEngine(jnet, cache_dtype="float32", **KW,
                       prefill_transport=jkt.RemotePrefillClient(
                           "127.0.0.1", tw.port, registry=JRegistry()))
        h = jeng.submit(ids, 5)
        jeng.run_until_idle()
        assert (jeng.remote_prefills, jeng.local_prefills) == (1, 0)
        assert h.tokens == want
        jeng.close()
    finally:
        tw.stop()


def test_transport_failures_fall_back(nets):
    """A dead worker: one fallback, then the cooldown keeps admissions
    off the socket; a version skew: a fallback; a sampled stream through
    the transport equals the one without; the prefill spans name the
    mode."""
    _, arrays, refs = nets
    net = _tnet(arrays)
    prompts = PROMPTS[3:6]
    clock = ChaosClock()
    dead = RemotePrefillClient("127.0.0.1", _free_port(), cooldown_s=60.0,
                               clock=clock)
    eng = _engine(net, prefill_transport=dead)
    hs = [eng.submit(p, 4) for p in prompts]
    eng.run_until_idle()
    assert [h.tokens for h in hs] == [r[:4] for r in refs[3:6]]
    assert (eng.remote_prefill_fallbacks, eng.local_prefills) == (1, 3)
    assert not dead.available()
    clock.advance(61.0)
    assert dead.available()
    worker = PrefillWorker(net, weights_version="STALE").start()
    sworker = PrefillWorker(net, do_sample=True, top_k=8).start()
    tracer = obs.Tracer(process="test", sample=1)
    prev = obs.set_tracer(tracer)
    try:
        skew = _engine(net, weights_version="wv2",
                       prefill_transport=RemotePrefillClient(
                           "127.0.0.1", worker.port, cooldown_s=60.0,
                           expected_weights_version="wv2"))
        h = skew.submit(prompts[0], 4)
        h.trace = tracer.start_trace("test.request")
        skew.run_until_idle()
        assert h.tokens == refs[3][:4]
        assert (skew.remote_prefills, skew.remote_prefill_fallbacks) == (0, 1)
        sampled = {}
        for name, tr in (("remote", RemotePrefillClient(
                "127.0.0.1", sworker.port)), ("local", None)):
            e = _engine(net, do_sample=True, temperature=0.8, top_k=8,
                        seed=3, prefill_transport=tr)
            hs = [e.submit(p, 6) for p in prompts]
            for x in hs:
                x.trace = tracer.start_trace("test.request")
            e.run_until_idle()
            sampled[name] = [x.tokens for x in hs]
            assert e.remote_prefills == (3 if tr else 0)
            e.close()
        assert sampled["remote"] == sampled["local"]
        spans = tracer.buffer.spans()
        modes = sorted(s["attrs"].get("mode") for s in spans
                       if s["name"] == "engine.prefill")
        assert modes == ["fallback"] + ["local"] * 3 + ["remote"] * 3
        names = {s["name"] for s in spans}
        assert {"kv.transfer", "worker.prefill"} <= names
    finally:
        obs.set_tracer(prev)
        worker.stop()
        sworker.stop()


# --------------------------------------------------------------- placement
def test_pick_matches_jax_router():
    """Over a seeded table of scraped statuses, breakers, drains,
    in-flight counts, exclusions and affinity keys, the port's placement
    picks JAX's replica every time (neither router started)."""
    rng = np.random.RandomState(7)
    addrs = [("127.0.0.1", 9000 + i) for i in range(4)]
    routers = []
    for mod, reg in ((FleetRouter, obs.MetricsRegistry()),
                     (JRouter, JRegistry())):
        clock = ChaosClock()
        routers.append((mod(addrs, registry=reg, clock=clock), clock))
    keys = [None, ("session", "a"), tuple(range(5)), (1, 2, 3)]
    bodies = [{"session_id": "a", "input_ids": [1]},
              {"input_ids": list(range(40))}, {"input_ids": []},
              {"input_ids": ["x"]}, {"session_id": "", "input_ids": [4]}]
    for body in bodies:
        assert routers[0][0]._affinity_key(body) == \
            routers[1][0]._affinity_key(body)
    picked = set()
    for trial in range(300):
        table = []
        for i in range(4):
            st = {k: int(rng.randint(0, n)) for k, n in (
                ("queue_depth", 4), ("active", 3), ("free_pages", 40))
                if rng.rand() < 0.9}
            table.append(dict(
                healthy=rng.rand() < 0.85, draining=rng.rand() < 0.1,
                status=st, age=float(rng.uniform(0, 4)),
                breaker=rng.rand() < 0.1, in_flight=int(rng.randint(0, 3))))
        akey = keys[rng.randint(len(keys))]
        owner = int(rng.randint(4))
        exclude = {int(i) for i in rng.choice(4, rng.randint(0, 3),
                                              replace=False)}
        out = []
        for router, clock in routers:
            now = clock()
            for r, row in zip(router.replicas, table):
                r.healthy, r.draining = row["healthy"], row["draining"]
                r.status = dict(row["status"])
                r.status_time = now - row["age"]
                r.breaker_open_until = now + 1.0 if row["breaker"] else 0.0
                r.in_flight = row["in_flight"]
            router._affinity.clear()
            router._note_affinity(akey, owner)
            r = router._pick(exclude=exclude, affinity_key=akey)
            out.append(None if r is None else r.index)
        assert out[0] == out[1], (trial, table, akey, owner, exclude)
        picked.add(out[0])
    assert picked == {None, 0, 1, 2, 3}


# ------------------------------------------------------------- the router
@pytest.fixture(scope="module")
def fleet(nets):
    """Two tiny fp32 replicas (nets of their own: the reload leg rewrites
    their weights) behind ``ServingFrontend``s and a router that scrapes
    only when a test asks (``health_interval_s`` 30)."""
    _, arrays, _ = nets
    fes = [ServingFrontend(_engine(_tnet(arrays)), port=0).start()
           for _ in range(2)]
    router = FleetRouter([("127.0.0.1", fe.port) for fe in fes],
                         health_interval_s=30.0).start()
    yield router, fes
    router.stop()
    for fe in fes:
        fe.stop(close_engine=True)
        assert not fe.driver_errors, list(fe.driver_errors)


def _routed(router):
    return dict(router.metrics.requests.by_label())


def test_router_streams_exact_and_spread(nets, fleet):
    """Four streams placed while both replicas' engine loops are held (so
    every placement sees the others in flight): they spread over both
    replicas and equal JAX ``generate`` and a direct stream; the
    exposition carries the per-replica series."""
    _, _, refs = nets
    router, fes = fleet
    router._scrape_all()
    before = _routed(router)
    out = [None] * 4

    def one(i):
        out[i] = _stream(router.port, PROMPTS[i], 3 + i)

    for fe in fes:
        fe._lock.acquire()
    try:
        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for _ in range(TIMEOUT * 100):
            if sum(r.in_flight for r in router.replicas) == 4:
                break
            threading.Event().wait(0.01)
    finally:
        for fe in fes:
            fe._lock.release()
    _join(threads)
    for i, ev in enumerate(out):
        assert _tokens(ev) == refs[i][:3 + i]
    assert _tokens(_stream(fes[1].port, PROMPTS[0], 3)) == _tokens(out[0])
    after = _routed(router)
    assert {k: after[k] - before.get(k, 0) for k in after} == \
        {"0": 2, "1": 2}
    st, text = _http(router.port, "GET", "/metrics")
    scrape = obs.parse_prometheus_text(text.decode())
    assert st == 200 and {lab["replica"] for lab, _ in scrape[
        "paddle_fleet_replica_free_pages"]} >= {"0", "1"}
    assert "paddle_fleet_requests_total" in scrape
    st, body = _http(router.port, "GET", "/replicas")
    assert st == 200 and [r["index"] for r in json.loads(body)[
        "replicas"]] == [0, 1]


def test_router_session_turns_stick(fleet):
    """Three turns of one session, each placed on a fresh scrape of an
    idle fleet: all on the replica the first turn took."""
    router, _ = fleet
    before = _routed(router)
    ids = [int(t) for t in RNG.randint(0, 64, (6,))]
    for turn in range(3):
        router._scrape_all()
        _tokens(_stream(router.port, ids + [turn], 3, session_id="chat-7"))
    after = _routed(router)
    delta = sorted(after[k] - before.get(k, 0) for k in after)
    assert delta[-1] == 3 and sum(delta) == 3


def test_router_retries_unstarted_past_dead_replica(nets, fleet):
    """A dead replica made to look best: requests placed on it have not
    started, so each retries on the live one, and the breaker opens."""
    _, _, refs = nets
    live = fleet[1][0]
    router = FleetRouter([("127.0.0.1", _free_port()),
                          ("127.0.0.1", live.port)],
                         registry=obs.MetricsRegistry(),
                         health_interval_s=30.0, breaker_threshold=2,
                         breaker_cooldown_s=60.0).start()
    try:
        for _ in range(3):
            r0 = router.replicas[0]
            r0.healthy = True
            r0.status = {"free_pages": 999, "queue_depth": 0, "active": 0}
            r0.status_time = router.clock()
            r0.breaker_open_until = 0.0
            router.replicas[1].status_time = router.clock()
            assert _tokens(_stream(router.port, PROMPTS[6], 3)) == \
                refs[6][:3]
        assert router.metrics.retries.by_label()["conn_error"] == 3
        assert router.metrics.breaker_opens.by_label()["0"] == 1
    finally:
        router.stop()


class _DyingReplica(http.server.BaseHTTPRequestHandler):
    """A replica whose SSE stream dies after two tokens."""

    def log_message(self, *a):
        pass

    def do_GET(self):
        body = json.dumps({"accepting": True, "free_pages": 999,
                           "queue_depth": 0, "active": 0}).encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self):
        # read the request first: closing a socket with unread input
        # resets it, and the reset can discard the tokens still in flight
        self.rfile.read(int(self.headers.get("Content-Length", 0)))
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.end_headers()
        for i in range(2):
            self.wfile.write(f"event: token\ndata: {{\"index\": {i}, "
                             f"\"token\": {i}}}\n\n".encode())
            self.wfile.flush()
        self.connection.close()


def test_router_midstream_death_ends_replica_failed():
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _DyingReplica)
    srv.daemon_threads = True
    th = threading.Thread(target=srv.serve_forever,
                          kwargs={"poll_interval": 0.05}, daemon=True)
    th.start()
    router = FleetRouter([("127.0.0.1", srv.server_address[1])],
                         registry=obs.MetricsRegistry(),
                         health_interval_s=30.0).start()
    try:
        ev = _stream(router.port, [1, 2, 3], 8)
        assert [e for e, _ in ev] == ["token", "token", "error"]
        assert ev[-1][1]["reason"] == "replica_failed"
        assert router.metrics.stream_aborts.by_label() == \
            {"replica_failed": 1}
    finally:
        router.stop()
        srv.shutdown()
        srv.server_close()
        _join([th])


def test_router_sheds_429_and_503(nets):
    """Every replica queue-full (one queue slot, a frozen step, a queued
    request): 429 ``fleet_saturated`` before any stream; a fleet of one
    dead replica: 503 ``no_replicas``."""
    _, arrays, _ = nets
    fes = []
    for _ in range(2):
        eng = _engine(_tnet(arrays), max_batch_size=1, max_queue_size=1)
        fe = ServingFrontend(eng).start()
        # an engine loop that never steps: the queued request holds the one
        # queue slot, and the loop takes no lock the handlers wait on
        fe._engine_busy = lambda: False
        with fe._lock:
            assert eng.submit(RNG.randint(0, 64, (1, 6)),
                              4).status == "QUEUED"
        fes.append(fe)
    router = FleetRouter([("127.0.0.1", fe.port) for fe in fes],
                         registry=obs.MetricsRegistry(),
                         health_interval_s=30.0).start()
    dead = FleetRouter([("127.0.0.1", _free_port())],
                       registry=obs.MetricsRegistry(),
                       health_interval_s=30.0).start()
    try:
        with pytest.raises(HTTPRejected) as ei:
            _stream(router.port, [1, 2, 3], 2)
        assert ei.value.code == 429 and ei.value.body == {
            "error": "rejected", "reason": "fleet_saturated",
            "replicas_tried": 2}
        assert router.metrics.retries.by_label() == {"replica_busy": 2}
        with pytest.raises(HTTPRejected) as ei:
            _stream(dead.port, [1, 2], 2)
        assert ei.value.code == 503
        assert ei.value.body["reason"] == "no_replicas"
        assert dead.metrics.shed.by_label() == {"no_replicas": 1}
    finally:
        router.stop()
        dead.stop()
        for fe in fes:
            fe.stop(close_engine=True)


def test_router_drain_drops_no_stream(nets, fleet):
    """``/admin/drain/0`` while a stream runs on replica 0: that stream
    finishes, new requests all go to replica 1, and ``/admin/undrain/0``
    puts it back."""
    _, _, refs = nets
    router, fes = fleet
    ids = PROMPTS[7]
    router._scrape_all()
    got = {}
    with fes[0]._lock, fes[1]._lock:
        th = threading.Thread(target=lambda: got.update(
            ev=_stream(router.port, ids, 6)))
        th.start()
        for _ in range(TIMEOUT * 100):
            if router.replicas[0].in_flight == 1:
                break
            threading.Event().wait(0.01)
        assert router.replicas[0].in_flight == 1
        st, body = _http(router.port, "POST", "/admin/drain/0")
        assert st == 200 and json.loads(body)["draining"] is True
    _join([th])
    assert _tokens(got["ev"]) == refs[7]
    before = _routed(router)
    for _ in range(3):
        router._scrape_all()
        _tokens(_stream(router.port, ids, 2))
    after = _routed(router)
    assert after["1"] - before.get("1", 0) == 3
    assert after.get("0", 0) == before.get("0", 0)
    st, body = _http(router.port, "POST", "/admin/undrain/0")
    assert st == 200 and json.loads(body)["draining"] is False
    _tokens(_stream(fes[0].port, ids, 2))


def test_router_rolling_reload_walk(nets, fleet, tmp_path):
    """``POST /admin/reload`` walks both replicas (drain, swap, undrain)
    onto a checkpoint of other weights; both then serve its tokens."""
    router, fes = fleet
    net2 = LlamaForCausalLM(LlamaConfig.tiny(**CFG), device="cpu", seed=9)
    mgr = CheckpointManager(str(tmp_path), network=net2, async_saves=False)
    mgr.save(9, blocking=True)
    mgr.close()
    ids = [2, 5, 7]
    want = [int(t) for t in net2.generate(
        np.asarray([ids]), max_new_tokens=4, cache_dtype="float32",
        graphs=False)[0, 3:]]
    st, body = _http(router.port, "POST", "/admin/reload",
                     {"ckpt_dir": str(tmp_path), "drain_timeout_s": 30})
    out = json.loads(body)
    assert st == 200 and out["ok"], out
    assert [r["weights_version"] for r in out["results"]] == \
        ["ckpt-9", "ckpt-9"]
    for fe in fes:
        ev = _stream(fe.port, ids, 4)
        assert _tokens(ev) == want
        assert ev[-1][1]["weights_version"] == "ckpt-9"
    router._scrape_all()
    assert _tokens(_stream(router.port, ids, 4)) == want


# ------------------------------------------------------------------ launch
def test_launched_prefill_worker_serves_in_process_bytes(_prefill_child):
    """``python -m paddle_tpu_torch.serving.fleet.launch --role prefill
    --device cpu``: its prefill (first token and every page) equals an
    in-process worker's over ``build_net`` of the same arguments, and it
    exits 0 on SIGTERM."""
    child = launch._wait_ready(*_prefill_child, "prefill", TIMEOUT)
    args = launch._parser().parse_args(["--role", "prefill", *CHILD_CLI])
    local = PrefillWorker(launch.build_net(args)).start()
    try:
        outs = []
        for port in (child.port, local.port):
            c = RemotePrefillClient("127.0.0.1", port, timeout_s=TIMEOUT)
            outs.append(c.prefill(list(range(1, 12)), 11, 16, 8,
                                  "bfloat16", 1.0, None))
            c.close()
        (t_child, flat_child), (t_local, flat_local) = outs
        assert t_child == t_local and len(flat_child) == 4
        for a, b in zip(flat_child, flat_local):
            assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    finally:
        local.stop()
        rc = child.terminate(timeout_s=TIMEOUT)
    assert rc == 0, list(child.tail)
    with pytest.raises(NotImplementedError, match="queue A item 7"):
        launch.main(["--aot-cache", "/nonexistent"])
