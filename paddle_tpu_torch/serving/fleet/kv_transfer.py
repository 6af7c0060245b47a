"""Cross-process prefill -> decode disaggregation: the KV transfer wire
(counterpart of ``paddle_tpu/serving/fleet/kv_transfer.py``).

A :class:`PrefillWorker` owns the prompt phase: it runs the engines'
bucketed prefill program (``engine.prefill_program``, captured as a CUDA
graph on a card over the worker's own block) and ships the finished KV
block to a decode replica as page payloads; the replica's
``PagedServingEngine`` copies them into a pooled block and adopts them
through its per-bucket adopt program, and the request enters the decode
batch as if it had prefilled locally.

Wire format (one socket, length-prefixed frames, CRC-checked)::

    frame := MAGIC(4) | payload_len(u64 BE) | crc32(u32 BE) | payload
    payload := header_len(u32 BE) | header_json | raw_bytes

A prefill exchange is one request frame (prompt ids, bucket geometry,
temperature and sampling key) answered by one ``prefilled`` meta frame
and then one frame per cache array (per layer K then V), each shaped
``[n_pages, page_size, kvH, D]``; an int8 array ships as two frames,
``q`` then ``scale``. An array crosses as its host bytes in C order under
its dtype name and shape; bf16 crosses as its raw 2-byte words under the
name ``"bfloat16"``, the name JAX writes. Every byte is the JAX
package's, so either package's worker serves the other's client. A
damaged frame (bad magic, short read, CRC mismatch) raises
:class:`TransferError`, and the engine falls back to a local prefill
(counted): disaggregation is an optimization, never a correctness
dependency.

The sampling key travels as the port's request key ``(seed, index)``
(``sampling_keys.py``) in the header's ``key`` list (``[0, 0]`` when
greedy), with the temperature; the worker samples the first token at
the position key the local path uses, so sampled streams are the same
with or without a transport. ``do_sample``, ``top_k`` and ``top_p`` are
fixed at the worker's construction, as in JAX. The page-frame codec
(``_encode_array``, ``_decode_array``) also serves the KV spill tier
(``serving/kv_tiering.py``).
"""
from __future__ import annotations

import contextlib
import json
import socket
import struct
import threading
import time
import zlib

import numpy as np
import torch

from ...observability.tracing import (
    format_traceparent,
    get_tracer,
    parse_traceparent,
    remote_child_span,
)
from ...quantization.kv import QuantizedKV, is_quantized
from ..chaos import poke as _chaos_poke

# Wire protocol version. PKV2 added the optional trace fields
# (``traceparent`` on the prefill request, ``span`` on the prefilled
# response), both in the header JSON: the frame layout is unchanged, so
# a PKV1 peer's frames still parse. Send the current magic, accept both.
MAGIC = b"PKV2"
MAGIC_V1 = b"PKV1"
_ACCEPTED_MAGICS = (MAGIC, MAGIC_V1)
_HEAD = struct.Struct(">QI")   # payload_len, crc32
_HLEN = struct.Struct(">I")    # header_json length
# one frame is at most a few pages of KV; anything past this is a
# corrupted length field, not a real payload
MAX_FRAME_BYTES = 1 << 31

# dtype name -> torch dtype, for the dtypes a KV page holds
_TORCH_DTYPES = {
    "float32": torch.float32, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "int8": torch.int8, "uint8": torch.uint8,
    "int16": torch.int16, "int32": torch.int32, "int64": torch.int64,
}


class TransferError(RuntimeError):
    """Any failure of the KV transfer path (connect, frame, CRC, a
    worker-side error, a refused payload). The decode engine catches
    exactly this and falls back to a local prefill; the spill tier
    counts it as a refusal."""


# ------------------------------------------------------------------ frames
def send_frame(sock, header, blob=b""):
    # chaos seam: a fault armed here IS a socket drop mid-exchange
    _chaos_poke("kv.send_frame", kind=header.get("kind")
                or header.get("part"))
    hj = json.dumps(header).encode("utf-8")
    head = _HLEN.pack(len(hj)) + hj
    # the payload's CRC and bytes as one buffer's, without joining a
    # page-sized blob onto the header
    crc = zlib.crc32(blob, zlib.crc32(head)) & 0xFFFFFFFF
    try:
        sock.sendall(MAGIC + _HEAD.pack(len(head) + len(blob), crc) + head)
        if len(blob):
            sock.sendall(blob)
    except OSError as e:
        raise TransferError(f"send failed: {e!r}")


def _no_delay(sock):
    """Send each frame's segments at once: a frame goes out as two writes
    (its head, then its blob), and Nagle's algorithm would hold the
    second behind the peer's delayed ACK (40 ms a small frame)."""
    try:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    except OSError:
        pass


def _recv_exact(sock, n):
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        try:
            k = sock.recv_into(view[got:], min(1 << 20, n - got))
        except OSError as e:
            raise TransferError(f"recv failed: {e!r}")
        if not k:
            raise TransferError("connection closed mid-frame")
        got += k
    return buf


def recv_frame(sock):
    """One frame -> ``(header, blob)``; ``blob`` is a read-only view of
    the payload's raw bytes."""
    _chaos_poke("kv.recv_frame")
    head = _recv_exact(sock, 4 + _HEAD.size)
    if bytes(head[:4]) not in _ACCEPTED_MAGICS:
        raise TransferError(f"bad frame magic {bytes(head[:4])!r}")
    length, crc = _HEAD.unpack(head[4:])
    if length < _HLEN.size or length > MAX_FRAME_BYTES:
        raise TransferError(f"implausible frame length {length}")
    payload = _recv_exact(sock, length)
    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
        raise TransferError("frame CRC mismatch")
    hlen = _HLEN.unpack(payload[:_HLEN.size])[0]
    if _HLEN.size + hlen > length:
        raise TransferError("frame header overruns payload")
    try:
        header = json.loads(bytes(payload[_HLEN.size:_HLEN.size + hlen])
                            .decode("utf-8"))
    except Exception as e:
        raise TransferError(f"bad frame header: {e!r}")
    return header, memoryview(payload)[_HLEN.size + hlen:].toreadonly()


def _encode_array(arr):
    """``(header, bytes)`` of one array (a torch tensor or anything numpy
    takes), its bytes in C order."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().to("cpu").contiguous()
        name = str(t.dtype).replace("torch.", "")
        if t.dtype == torch.bfloat16:
            data = t.view(torch.int16).numpy().tobytes()
        else:
            data = t.numpy().tobytes()
        return {"dtype": name, "shape": list(t.shape)}, data
    a = np.asarray(arr)
    return {"dtype": str(a.dtype), "shape": list(a.shape)}, a.tobytes()


def _itemsize(name):
    dt = _TORCH_DTYPES.get(name)
    if dt is None:
        raise TransferError(f"unsupported array dtype {name!r}")
    return torch.empty((), dtype=dt).element_size()


def _decode_array(header, blob):
    """One array of a frame as a CPU torch tensor (its own storage)."""
    name = header["dtype"]
    n = int(np.prod(header["shape"])) * _itemsize(name)
    if len(blob) != n:
        raise TransferError(
            f"array payload {len(blob)}B != expected {n}B for "
            f"{name}{header['shape']}"
        )
    dt = _TORCH_DTYPES[name]
    if n == 0:
        return torch.empty(header["shape"], dtype=dt)
    return torch.frombuffer(bytearray(blob), dtype=dt).reshape(
        header["shape"])


def _flat_leaves(flat):
    """The tensors of a flat block (per layer K then V; an int8 cache's
    codes then scales), in frame order."""
    out = []
    for t in flat:
        out += [t.q, t.scale] if is_quantized(t) else [t]
    return out


def request_key(key):
    """The header's ``key`` list of a port request key ``(seed, index)``,
    ``[0, 0]`` for a greedy engine's None (JAX sends its threefry key's
    two words; a greedy worker reads neither)."""
    if key is None:
        return [0, 0]
    return [int(x) for x in np.asarray(key).ravel()]


# ------------------------------------------------------------------ worker
class PrefillWorker:
    """The prefill pool's unit: a socket server that runs bucketed
    prefill and ships the finished KV pages.

    Serves ``ping``, ``reload`` and ``prefill`` requests, one thread a
    connection, the compute under one lock. Each ``(bucket, cache
    dtype)`` has one block of its own (``alloc_kv_caches(cfg, 1,
    bucket)``), rewritten by every prefill of that bucket, and one
    program over it (``serving/programs.py``: the engines' prefill body,
    a CUDA graph on a card). A program is captured at its first request;
    send one request a bucket before traffic (``launch._warmup`` does),
    since a capture fails while another thread of the process launches
    CUDA work. Each connection's thread runs on the worker's device and
    a stream of the worker's own, and the block reaches the host through
    pinned buffers on that stream.
    ``reload_weights`` copies a committed checkpoint into the net's own
    tensors under the lock (the programs hold their addresses)."""

    def __init__(self, net, *, host="127.0.0.1", port=0, do_sample=False,
                 top_k=0, top_p=1.0, weights_version=None):
        from ..programs import Programs

        self.net = net.eval()
        self.config = net.config
        self.device = net.device
        self.do_sample = bool(do_sample)
        self.top_k = int(top_k)
        self.top_p = float(top_p) if top_p is not None else 1.0
        self.weights_version = (
            "v0" if weights_version is None else str(weights_version)
        )
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._programs = Programs(self.device, kinds=("prefill",))
        self._blocks = {}   # (bucket, dtype name) -> block caches
        self._pinned = {}   # (bucket, dtype name) -> pinned host leaves
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self.host = host
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, int(port)))
        self._listener.listen(16)
        self.port = self._listener.getsockname()[1]
        self._accept_thread = None
        self._conns = set()
        self.served = 0
        self.errors = 0

    # ---------------------------------------------------------- lifecycle
    def start(self):
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="paddle-prefill-worker",
            daemon=True,
        )
        self._accept_thread.start()
        return self

    def stop(self):
        """Close the listener and every open connection, then join the
        accept thread and the connection threads (5 s each)."""
        self._stop.set()
        try:
            # a shutdown wakes the accept() that a close alone leaves
            # blocked
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:
            conns = list(self._conns)
        for conn, _ in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5)
            self._accept_thread = None
        for _, th in conns:
            th.join(timeout=5)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    def stats(self):
        with self._lock:
            return {
                "port": self.port,
                "served": self.served,
                "errors": self.errors,
                "weights_version": self.weights_version,
                "buckets": sorted({b for b, _ in self._blocks}),
            }

    def compile_counts(self):
        """Captures of the worker's prefill programs
        (``serving::prefill``)."""
        return dict(self._programs.counts)

    # ------------------------------------------------------------- serving
    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return  # listener closed
            _no_delay(conn)
            th = threading.Thread(target=self._serve_conn, args=(conn,),
                                  name="paddle-prefill-conn", daemon=True)
            with self._lock:
                self._conns.add((conn, th))
            th.start()

    def _device_context(self):
        """The worker's device and stream, entered by each connection's
        thread (a thread's current CUDA device and stream are its own)."""
        if self._stream is None:
            return contextlib.nullcontext()
        torch.cuda.set_device(self.device)
        return torch.cuda.stream(self._stream)

    def _serve_conn(self, conn):
        conn.settimeout(60.0)
        try:
            with self._device_context():
                self._serve_requests(conn)
        finally:
            try:
                conn.close()
            except OSError:
                pass
            with self._lock:
                self._conns = {c for c in self._conns if c[0] is not conn}

    def _serve_requests(self, conn):
        while not self._stop.is_set():
            try:
                req, _ = recv_frame(conn)
            except TransferError:
                return  # client went away / corrupt stream
            try:
                if req.get("kind") == "ping":
                    send_frame(conn, {"kind": "pong",
                                      "stats": self.stats()})
                    continue
                if req.get("kind") == "reload":
                    res = self.reload_weights(
                        req["ckpt_dir"],
                        weights_version=req.get("weights_version"),
                    )
                    send_frame(conn, {"kind": "reloaded", **res})
                    continue
                if req.get("kind") != "prefill":
                    raise ValueError(
                        f"unknown request kind {req.get('kind')!r}")
                self._handle_prefill(conn, req)
                with self._lock:
                    self.served += 1
            except TransferError:
                with self._lock:
                    self.errors += 1
                return  # send path broken; nothing else to say
            except Exception as e:
                with self._lock:
                    self.errors += 1
                try:
                    send_frame(conn, {"kind": "error", "error": repr(e)})
                except TransferError:
                    return

    def reload_weights(self, ckpt_dir, weights_version=None):
        """Rotate the prefill side onto a committed checkpoint: the
        engines' verify, load and validate path (``reload.py``), then the
        staged tensors copied into the net's parameters and buffers under
        the serving lock (never mid-prefill). Returns the result as a
        plain dict (it travels as the ``reloaded`` frame)."""
        from ..reload import apply_state_swap, prepare_state_swap

        params = dict(self.net.named_parameters())
        buffers = dict(self.net.named_buffers())
        staged = prepare_state_swap(self.net, params, buffers, ckpt_dir,
                                    weights_version=weights_version)
        if staged.ok:
            with self._lock, self._device_context():
                apply_state_swap(staged, params, buffers)
                self.weights_version = staged.weights_version
                staged.outcome = "applied"
        return staged.to_json()

    def _block(self, bucket, dtype_name):
        """The block of ``(bucket, dtype)`` and the function that builds
        its program."""
        from ...models.generation import alloc_kv_caches
        from ..engine import prefill_program

        key = (bucket, dtype_name)
        caches = self._blocks.get(key)
        if caches is None:
            caches = self._blocks[key] = alloc_kv_caches(
                self.config, 1, bucket, dtype_name, device=self.device)
        net = self.net

        def build():
            body, inputs = prefill_program(net, caches, bucket, self.device)
            keep = (tuple(net.state_dict(keep_vars=True).values()), caches)
            return body, inputs, keep
        return caches, build

    def _host_leaves(self, key, leaves):
        """``leaves`` copied into the key's pinned host buffers on the
        current stream, which is then synchronized."""
        host = self._pinned.get(key)
        if host is None:
            pin = self.device.type == "cuda"
            host = self._pinned[key] = [
                torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
                for t in leaves]
        for h, t in zip(host, leaves):
            h.copy_(t, non_blocking=True)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return host

    def _handle_prefill(self, conn, req):
        from ...models.generation import _select_next, normalize_cache_dtype

        bucket = int(req["bucket"])
        ps = int(req["page_size"])
        prompt = [int(t) for t in req["prompt"]]
        L = int(req["prompt_len"])
        if L != len(prompt) or not 1 <= L <= bucket:
            raise ValueError(
                f"prompt_len {L} inconsistent with prompt/bucket "
                f"{len(prompt)}/{bucket}")
        if ps < 1 or bucket % ps:
            raise ValueError(f"page_size {ps} must divide bucket {bucket}")
        dtype_name = normalize_cache_dtype(req["cache_dtype"])
        # PKV2 trace propagation: the compute is timed under a tracer-less
        # span shipped back in the response header; the CLIENT records it
        wsp = None
        ctx = parse_traceparent(req.get("traceparent"))
        if ctx is not None:
            wsp = remote_child_span("worker.prefill", ctx, "prefill_worker")
            wsp.set(bucket=bucket, prompt_len=L)
        ids = np.zeros((1, bucket), np.int64)
        ids[0, :L] = prompt
        key = (tuple(int(x) for x in req["key"]) if self.do_sample
               else None)
        with self._lock, torch.inference_mode():
            caches, build = self._block(bucket, dtype_name)
            logits = self._programs.run(("prefill", bucket, dtype_name),
                                        build, ids)[:, L - 1, :]
            # the first sampled token lands at cache position L, as on
            # the engines' local path
            nxt = _select_next(logits, self.do_sample,
                               float(req.get("temperature", 1.0)),
                               self.top_k, self.top_p, [(key, L)])
            t0 = int(nxt[0])
            flat = [t for kv in caches for t in kv]
            host = self._host_leaves((bucket, dtype_name),
                                     _flat_leaves(flat))
            # the frames' bytes are this request's own before the lock
            # goes: the next prefill of the bucket rewrites the block and
            # its pinned buffers while these frames are still being sent
            n_pages = bucket // ps
            frames, leaves = [], iter(host)
            for arr in flat:
                for part in (("q", "scale") if is_quantized(arr)
                             else ("dense",)):
                    t = next(leaves)
                    h, b = _encode_array(t[0].reshape(n_pages, ps,
                                                      *t.shape[2:]))
                    frames.append((dict(h, part=part), b))
            version = self.weights_version
        meta = {
            "kind": "prefilled", "first_token": t0, "bucket": bucket,
            "page_size": ps, "n_pages": n_pages,
            "cache_dtype": dtype_name, "entries": len(flat),
            "weights_version": version,
        }
        if wsp is not None:
            wsp.finish(weights_version=version)
            meta["span"] = wsp.to_dict()
        send_frame(conn, meta)
        for h, b in frames:
            send_frame(conn, h, b)


# ------------------------------------------------------------------ client
class RemotePrefillClient:
    """The decode replica's end of the transfer: attached to a
    ``PagedServingEngine`` as ``prefill_transport``, it ships each
    admission's prompt to the prefill pool and returns ``(first_token,
    flat_block)``, the block as CPU tensors ``[1, bucket, kvH, D]`` per
    layer K then V (``QuantizedKV`` pairs for int8), which the engine
    copies into a pooled block and adopts.

    Single-threaded by design (only the thread that steps the engine
    calls it). Any failure raises :class:`TransferError` AND opens a cooldown
    window: ``available()`` is False for ``cooldown_s``, so a dead worker
    costs one connect timeout, not one per admission; then it half-opens
    for a fresh attempt."""

    def __init__(self, host, port, *, timeout_s=10.0, cooldown_s=2.0,
                 expected_weights_version=None, registry=None,
                 clock=time.monotonic):
        from ..metrics import Counter

        self.host = host
        self.port = int(port)
        self.timeout_s = float(timeout_s)
        self.cooldown_s = float(cooldown_s)
        self.expected_weights_version = expected_weights_version
        self.clock = clock
        self._sock = None
        self._down_until = 0.0
        self.transfers = Counter(
            "kv_transfers", labelname="outcome",
            prom_name="paddle_fleet_kv_transfers_total",
            help="remote prefill transfers, by outcome")
        self.transfer_bytes = Counter(
            "kv_transfer_bytes",
            prom_name="paddle_fleet_kv_transfer_bytes_total",
            help="KV page payload bytes received from the prefill pool")
        if registry is None:
            from ...observability import get_registry

            registry = get_registry()
        registry.register_all([self.transfers, self.transfer_bytes])

    def available(self):
        return self.clock() >= self._down_until

    def close(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _mark_down(self):
        self.close()
        self._down_until = self.clock() + self.cooldown_s

    def _connection(self):
        if self._sock is None:
            self._sock = socket.create_connection(
                (self.host, self.port), timeout=self.timeout_s)
            _no_delay(self._sock)
        return self._sock

    def prefill(self, prompt, prompt_len, bucket, page_size, cache_dtype,
                temperature, key, trace=None):
        """One remote prefill -> ``(first_token, flat_block)``. Raises
        :class:`TransferError` on ANY failure, after opening the cooldown
        window.

        ``trace`` (a Span or None) makes the exchange traced: a
        ``kv.transfer`` wire span brackets the round trip, its
        traceparent rides the request header, and the worker's returned
        ``worker.prefill`` span lands in this process's trace buffer.

        A failure on a REUSED connection gets one fresh-connection retry
        first: the worker idle-closes connections (and may have
        restarted), and a stale cached socket must not demote a healthy
        worker to local prefill and a cooldown. Prefill is pure compute,
        so the retry is safe to replay."""
        tr = get_tracer()
        wire = None if trace is None else tr.start_span(
            "kv.transfer", trace,
            worker=f"{self.host}:{self.port}", bucket=int(bucket),
        )
        tid = None if wire is None else wire.trace_id
        args = (prompt, prompt_len, bucket, page_size, cache_dtype,
                temperature, key, wire)
        reused = self._sock is not None
        try:
            t0, flat, nbytes, wspan = self._prefill_once(*args)
        except TransferError as e:
            retried = False
            if reused:
                self.close()
                retried = True
                try:
                    t0, flat, nbytes, wspan = self._prefill_once(*args)
                except TransferError as e2:
                    e, retried = e2, False
            if not retried:
                self._mark_down()
                self.transfers.inc(label="error", trace_id=tid)
                if wire is not None:
                    wire.finish(outcome="error", error=str(e))
                raise e
        self.transfers.inc(label="ok", trace_id=tid)
        self.transfer_bytes.inc(nbytes, trace_id=tid)
        if wire is not None:
            wire.finish(outcome="ok", bytes=nbytes)
            if wspan:
                tr.buffer.add(wspan)
        return t0, flat

    def _prefill_once(self, prompt, prompt_len, bucket, page_size,
                      cache_dtype, temperature, key, wire=None):
        try:
            sock = self._connection()
            req = {
                "kind": "prefill",
                "prompt": [int(t) for t in prompt],
                "prompt_len": int(prompt_len),
                "bucket": int(bucket),
                "page_size": int(page_size),
                "cache_dtype": str(cache_dtype),
                "temperature": float(temperature),
                "key": request_key(key),
            }
            if wire is not None:
                req["traceparent"] = format_traceparent(wire)
            send_frame(sock, req)
            meta, _ = recv_frame(sock)
            if meta.get("kind") == "error":
                raise TransferError(f"worker error: {meta.get('error')}")
            if meta.get("kind") != "prefilled":
                raise TransferError(
                    f"unexpected response kind {meta.get('kind')!r}")
            if (self.expected_weights_version is not None
                    and meta.get("weights_version")
                    != self.expected_weights_version):
                raise TransferError(
                    f"weights version skew: worker serves "
                    f"{meta.get('weights_version')!r}, engine expects "
                    f"{self.expected_weights_version!r}")
            bkt = int(meta["bucket"])
            flat, nbytes = [], 0
            for _ in range(int(meta["entries"])):
                h, blob = recv_frame(sock)
                nbytes += len(blob)
                if h.get("part") == "q":
                    hs, sb = recv_frame(sock)
                    nbytes += len(sb)
                    if hs.get("part") != "scale":
                        raise TransferError(
                            "quantized entry missing its scale frame")
                    q = _decode_array(h, blob)
                    s = _decode_array(hs, sb)
                    kvh, d = q.shape[2], q.shape[3]
                    flat.append(QuantizedKV(q.reshape(1, bkt, kvh, d),
                                            s.reshape(1, bkt, kvh)))
                else:
                    a = _decode_array(h, blob)
                    kvh, d = a.shape[2], a.shape[3]
                    flat.append(a.reshape(1, bkt, kvh, d))
        except TransferError:
            self.close()  # protocol state unknown; never reuse it
            raise
        except (OSError, KeyError, ValueError, RuntimeError) as e:
            self.close()
            raise TransferError(repr(e))
        return (int(meta["first_token"]), flat, nbytes, meta.get("span"))

    def reload(self, ckpt_dir, weights_version=None,
               reload_timeout_s=120.0):
        """Ask the worker to rotate onto a committed checkpoint. Returns
        the worker's reload-result dict; on success with a version-pinned
        client, ``expected_weights_version`` follows the worker. Raises
        :class:`TransferError` on transport failure.

        The reply arrives only after the worker has verified and loaded
        the whole checkpoint, so the exchange runs under its own
        ``reload_timeout_s``. Like :meth:`prefill`, a failure on a REUSED
        connection gets one fresh-connection retry (prepare is pure,
        apply idempotent)."""
        reused = self._sock is not None
        try:
            meta = self._reload_once(ckpt_dir, weights_version,
                                     reload_timeout_s)
        except TransferError:
            if not reused:
                self._mark_down()
                raise
            self.close()
            try:
                meta = self._reload_once(ckpt_dir, weights_version,
                                         reload_timeout_s)
            except TransferError:
                self._mark_down()
                raise
        if meta.get("ok") and self.expected_weights_version is not None:
            self.expected_weights_version = meta.get("weights_version")
        return meta

    def _reload_once(self, ckpt_dir, weights_version, reload_timeout_s):
        try:
            sock = self._connection()
            sock.settimeout(float(reload_timeout_s))
            try:
                send_frame(sock, {
                    "kind": "reload", "ckpt_dir": str(ckpt_dir),
                    "weights_version": weights_version,
                })
                meta, _ = recv_frame(sock)
            finally:
                try:
                    sock.settimeout(self.timeout_s)
                except OSError:
                    pass
            if meta.get("kind") != "reloaded":
                raise TransferError(
                    f"unexpected reload response {meta.get('kind')!r}")
        except TransferError:
            self.close()  # protocol state unknown; never reuse it
            raise
        except OSError as e:
            self.close()
            raise TransferError(repr(e))
        return meta

    def ping(self):
        """Round-trip liveness probe: the worker's stats dict, or
        :class:`TransferError`."""
        try:
            sock = self._connection()
            send_frame(sock, {"kind": "ping"})
            meta, _ = recv_frame(sock)
            if meta.get("kind") != "pong":
                raise TransferError(
                    f"unexpected ping response {meta.get('kind')!r}")
            return meta.get("stats", {})
        except (OSError, TransferError) as e:
            self._mark_down()
            raise TransferError(repr(e))
