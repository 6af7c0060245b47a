"""Subprocess entry points and spawn helpers for fleet components (the
port of ``paddle_tpu/serving/fleet/launch.py``).

``python -m paddle_tpu_torch.serving.fleet.launch --role replica`` puts a
``PagedServingEngine`` behind a ``ServingFrontend`` on an ephemeral port;
``--role prefill`` starts a :class:`~.kv_transfer.PrefillWorker`;
``--role router`` a :class:`~.router.FleetRouter` over ``--replicas``.
Each prints exactly one line::

    FLEET_READY role=<role> port=<port>

to stdout once it is serving, then runs until SIGTERM or SIGINT
(replicas stop the front end and close the engine on the way out). The
model is ``LlamaConfig.tiny`` at the launch's knobs, its weights drawn
from a ``torch.Generator`` seeded with ``--seed``, so every process
launched with the same arguments on the same device serves identical
weights: that is what makes router fail-over and disaggregated prefill
token-exact across processes. The model runs on ``--device`` (default
``cuda:0``, which raises without a card; the CPU tests pass ``--device
cpu``), never on the CPU unless asked.

:func:`spawn` is the parent-side helper the tests and ``chip_smoke.py``
share: launch, wait for the READY line, keep draining the child's output
into a bounded tail ring (so a chatty child never blocks on a full
pipe), and hand back the port. A parent that runs the kernels on a card
builds them before it spawns (children reuse the built library; two
children building one directory at once could race).
"""
from __future__ import annotations

import argparse
import collections
import os
import queue
import signal
import subprocess
import sys
import threading
import time


def build_net(args):
    """The launch's model: ``LlamaConfig.tiny`` at the knobs (the FFN
    twice the hidden width, as JAX's launch builds it), fp32 weights from
    a generator seeded with ``--seed``, on ``--device``, in eval mode."""
    from ...models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.tiny(
        vocab_size=args.vocab, hidden_size=args.hidden,
        intermediate_size=2 * args.hidden,
        num_hidden_layers=args.layers,
        num_attention_heads=args.heads,
    )
    net = LlamaForCausalLM(cfg, device=args.device, seed=args.seed)
    net.eval()
    return net


def _warmup(engine, args):
    """Capture every fixed-shape program before the READY line, so the
    first real requests pay sockets, not captures.

    ``engine.warmup`` captures the decode step and a prefill and an adopt
    per prompt bucket: the local-fallback prefill programs are warm even
    with a prefill transport attached, so a worker outage never stalls
    decode behind a capture. One real request then runs end to end
    (transport detached: warmup traffic must not consume the prefill
    pool); with a transport attached, one request per bucket also runs
    THROUGH it, so the prefill worker captures its per-bucket programs
    now, before any traffic (a capture fails while another thread of its
    process launches CUDA work)."""
    import numpy as np

    stats = engine.warmup()
    print(f"FLEET_WARMUP programs={stats['programs']} "
          f"aot_hits={stats['aot_hits']} "
          f"aot_saves={stats['aot_saves']}", flush=True)
    transport = engine.prefill_transport
    engine.prefill_transport = None
    try:
        L = min(args.min_bucket, args.max_seq - 2)
        h = engine.submit(np.zeros((1, L), np.int32), 2)
        engine.run_until_idle()
        if h.status != "DONE":
            raise RuntimeError(
                f"warmup request ended {h.status} ({h.reason})")
    finally:
        engine.prefill_transport = transport
    if transport is not None:
        bucket = engine.pool.bucket_for(min(args.min_bucket,
                                            args.max_seq - 2))
        while bucket <= args.max_seq:
            L = min(bucket, args.max_seq - 2)
            h = engine.submit(np.zeros((1, L), np.int32), 2)
            engine.run_until_idle()
            if h.status != "DONE":
                raise RuntimeError(
                    f"remote warmup for bucket {bucket} ended "
                    f"{h.status} ({h.reason})")
            if bucket >= args.max_seq:
                break
            bucket *= 2
    engine.metrics = type(engine.metrics)()
    engine.remote_prefills = 0
    engine.local_prefills = 0
    engine.remote_prefill_fallbacks = 0


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--role", choices=("replica", "prefill", "router"),
                    default="replica")
    # router role
    ap.add_argument("--replicas", default=None,
                    metavar="HOST:PORT,HOST:PORT",
                    help="router: comma-separated replica frontends")
    ap.add_argument("--watch-ckpt-root", default=None, metavar="DIR",
                    help="router: poll this checkpoint root and run "
                         "the rolling /admin/reload walk whenever a "
                         "NEW manifest-committed step appears")
    ap.add_argument("--watch-interval", type=float, default=1.0,
                    help="router: checkpoint-root poll period, seconds")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    # model (must match across the fleet for exactness)
    ap.add_argument("--vocab", type=int, default=64)
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default="cuda:0",
                    help="torch device of the model (default cuda:0; "
                         "'cpu' runs the plain PyTorch path)")
    # engine geometry
    ap.add_argument("--max-batch", type=int, default=2)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--min-bucket", type=int, default=8)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--num-pages", type=int, default=None)
    ap.add_argument("--max-queue", type=int, default=64)
    ap.add_argument("--cache-dtype", default="bfloat16")
    ap.add_argument("--weights-version", default="v0")
    ap.add_argument("--prefill-worker", default=None, metavar="HOST:PORT",
                    help="attach this replica to a prefill pool worker "
                         "(disaggregated prefill with local fallback)")
    ap.add_argument("--aot-cache", default=None, metavar="DIR",
                    help="persistent AOT compile cache (not ported: "
                         "raises)")
    ap.add_argument("--no-warmup", dest="warmup", action="store_false")
    return ap


def main(argv=None):
    ap = _parser()
    args = ap.parse_args(argv)
    if args.aot_cache is not None:
        raise NotImplementedError(
            "--aot-cache: the AOT executable cache is not ported "
            "(ROADMAP.md queue A item 7)")

    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *a: stop.set())

    # name this process's trace rows before any span exists: stitched
    # fleet traces show router, replica and prefill_worker as separate
    # process lanes (the spawner may set PADDLE_TPU_TRACE_PROCESS)
    from ...observability.tracing import set_process_name

    set_process_name(os.environ.get("PADDLE_TPU_TRACE_PROCESS")
                     or ("prefill_worker" if args.role == "prefill"
                         else args.role))

    if args.role == "router":
        if not args.replicas:
            ap.error("--role router requires --replicas")
        from .router import FleetRouter

        router = FleetRouter(
            [s.strip() for s in args.replicas.split(",") if s.strip()],
            host=args.host, port=args.port,
            watch_ckpt_root=args.watch_ckpt_root,
            watch_interval_s=args.watch_interval,
        ).start()
        print(f"FLEET_READY role=router port={router.port}", flush=True)
        stop.wait()
        router.stop()
        return 0

    net = build_net(args)

    if args.role == "prefill":
        from .kv_transfer import PrefillWorker

        worker = PrefillWorker(
            net, host=args.host, port=args.port,
            weights_version=args.weights_version,
        ).start()
        print(f"FLEET_READY role=prefill port={worker.port}", flush=True)
        stop.wait()
        worker.stop()
        return 0

    from ..http_frontend import ServingFrontend
    from ..paged_engine import PagedServingEngine

    transport = None
    if args.prefill_worker:
        from .kv_transfer import RemotePrefillClient

        whost, _, wport = args.prefill_worker.rpartition(":")
        transport = RemotePrefillClient(
            whost or "127.0.0.1", int(wport),
            expected_weights_version=args.weights_version,
        )
    engine = PagedServingEngine(
        net, max_batch_size=args.max_batch, max_seq_len=args.max_seq,
        min_bucket=args.min_bucket, page_size=args.page_size,
        num_pages=args.num_pages, max_queue_size=args.max_queue,
        cache_dtype=args.cache_dtype,
        weights_version=args.weights_version,
        prefill_transport=transport,
    )
    if args.warmup:
        _warmup(engine, args)
    fe = ServingFrontend(engine, host=args.host, port=args.port).start()
    print(f"FLEET_READY role=replica port={fe.port}", flush=True)
    stop.wait()
    fe.stop(close_engine=True)
    return 0


# --------------------------------------------------------------- spawning
class FleetProc:
    """A spawned fleet component: the Popen, its READY port, and a bounded
    tail of its merged stdout/stderr (diagnostics on failure; the drain
    keeps the child from blocking on a full pipe). ``lines`` is the queue
    the spawn-time reader thread feeds (``None`` marks EOF)."""

    def __init__(self, proc, port, role, lines):
        self.proc = proc
        self.port = port
        self.role = role
        self._lines = lines
        self.tail = collections.deque(maxlen=400)
        self._drainer = threading.Thread(target=self._drain, daemon=True)
        self._drainer.start()

    def _drain(self):
        while True:
            line = self._lines.get()
            if line is None:
                return
            self.tail.append(line.rstrip("\n"))

    @property
    def alive(self):
        return self.proc.poll() is None

    def terminate(self, timeout_s=15.0):
        """Graceful stop (SIGTERM, then SIGKILL after the timeout);
        returns the exit code."""
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout_s)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(5)
        self._drainer.join(timeout=5)
        return self.proc.returncode

    def kill(self):
        """SIGKILL (the replica-death scenario)."""
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(5)
        self._drainer.join(timeout=5)
        return self.proc.returncode


def _popen(role, cli_args, env):
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    child_env = dict(os.environ)
    child_env.update(env or {})
    child_env["PYTHONUNBUFFERED"] = "1"
    child_env["PYTHONPATH"] = (
        repo_root + os.pathsep + child_env.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", "paddle_tpu_torch.serving.fleet.launch",
           "--role", role, *[str(a) for a in cli_args]]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=child_env, cwd=repo_root,
    )
    # a reader thread owns the pipe: readline() in the caller would block
    # past the deadline on a child that wedges without printing
    lines = queue.Queue()

    def _reader():
        try:
            for line in proc.stdout:
                lines.put(line)
        except ValueError:
            pass  # pipe closed at shutdown
        lines.put(None)

    threading.Thread(target=_reader, daemon=True).start()
    return proc, lines


def _wait_ready(proc, lines, role, timeout_s):
    head = []
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            line = lines.get(timeout=min(
                1.0, max(deadline - time.monotonic(), 0.05)))
        except queue.Empty:
            continue
        if line is None:
            proc.wait()
            raise RuntimeError(
                f"fleet {role} exited rc={proc.returncode} before "
                f"READY:\n" + "\n".join(head[-40:]))
        head.append(line.rstrip("\n"))
        if line.startswith("FLEET_READY"):
            port = int(line.rsplit("port=", 1)[1].strip())
            fp = FleetProc(proc, port, role, lines)
            fp.tail.extend(head)
            return fp
    proc.kill()
    proc.wait(5)
    raise RuntimeError(
        f"fleet {role} not READY within {timeout_s}s:\n"
        + "\n".join(head[-40:]))


def spawn(role="replica", cli_args=(), *, timeout_s=300.0, env=None):
    """Launch one fleet component subprocess and wait for its READY line.
    Returns a :class:`FleetProc`. Raises RuntimeError (with the child's
    output) when the child dies or never reports ready."""
    proc, lines = _popen(role, cli_args, env)
    return _wait_ready(proc, lines, role, timeout_s)


def spawn_all(specs, *, timeout_s=300.0, env=None):
    """Launch MANY components concurrently: all Popens start first, then
    each READY line is awaited, so the children's warmups run in
    parallel. ``specs`` is a list of ``(role, cli_args)``. On any failure
    the already-spawned children are killed before the error
    propagates."""
    started = [(role, *_popen(role, args, env)) for role, args in specs]
    procs = []
    try:
        for role, proc, lines in started:
            procs.append(_wait_ready(proc, lines, role, timeout_s))
    except BaseException:
        for _, proc, _ in started:
            if proc.poll() is None:
                proc.kill()
                proc.wait(5)
        raise
    return procs


if __name__ == "__main__":
    sys.exit(main())
