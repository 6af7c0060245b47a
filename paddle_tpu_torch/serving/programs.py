"""The serving engines' fixed-shape programs (the torch counterpart of the
JAX engines' jitted decode step, prefill and adopt programs, the prefix
cache's gather and chunk-prefill programs, speculative decoding's draft
and verify programs, and of their ``warmup()``).

A :class:`Program` holds one body (a function of fixed-shape tensors),
its static input tensors and, on a CUDA device, a ``torch.cuda.CUDAGraph``
captured from the body over those inputs. A call copies the step's host
arrays into the static inputs and replays the graph; its result is the
static outputs, which the next replay overwrites (read them first). On
the CPU the same body runs as a plain call over the same static inputs,
so the CPU tests drive the programs' bodies and their boundaries.

Capture (at a program's first call, as ``jax.jit`` compiles at the
first call, or from ``warmup()``):

- the body runs once eagerly on the capture stream. That run IS the
  call's step (its outputs are returned, its launches counted, its cache
  writes the ones the eager engine makes), and it builds what the kernels
  build lazily at their first call (the kernel library, the TMA entry
  point, the rope tables, paged attention's arrival counters), so that
  nothing is first created inside the capture;
- then the body is captured, into one memory pool per engine: replays
  never overlap, so graphs share their intermediates, while every
  program keeps its static outputs referenced, so no later capture
  reuses them. A capture launches nothing: the kernels' Python launch
  counters move while the body is recorded, so their difference is
  taken and undone, and added back at every replay
  (``kernels.measure_launches``);
- a capture or a replay that fails raises. Nothing falls back to the
  eager step.

A program reads the weights it was captured with, at their addresses,
and keeps them referenced. So new weights are copied INTO that storage:
a live reload (``reload.py``) writes the staged tensors into the net's
parameters and buffers in place and no program is captured again (the
JAX engine swaps its parameter snapshot instead). A tensor that is
replaced rather than written is not seen by the programs.
"""
from __future__ import annotations

import gc

import numpy as np
import torch

from .. import kernels

# the JAX trace guard's keys (``paddle_tpu/serving/engine.py``), under
# which an engine counts its captures
TRACE_KEYS = {"decode": "serving::decode_step",
              "prefill": "serving::prefill",
              "adopt": "serving::adopt",
              "gather": "serving::gather_pages",
              "chunk": "serving::chunk_prefill",
              "spec_gather": "serving::spec_gather",
              "spec_dprefill": "serving::spec_draft_prefill",
              "spec_ddecode": "serving::spec_draft_decode",
              "spec_verify": "serving::spec_verify"}
# the JAX engine's names of the programs (its memory table's keys), by
# kind, formatted with the key's remaining fields
NAMES = {"decode": "decode", "prefill": "prefill_b{}", "adopt": "adopt_b{}",
         "gather": "gather_b{}", "chunk": "chunk_b{}_t{}",
         "spec_gather": "spec_gather",
         "spec_dprefill": "spec_draft_prefill_b{}",
         "spec_ddecode": "spec_draft_decode_r{}",
         "spec_verify": "spec_verify_w{}_k{}"}
# the kinds every engine has; a prefix-cache engine adds gather and chunk
BASE_KINDS = ("decode", "prefill", "adopt")
# a speculative engine's: draft prefill per bucket, draft decode per row,
# verify per (width, k1); its gather is the slab's spec_gather or the
# paged engine's gather
SPEC_KINDS = ("spec_dprefill", "spec_ddecode", "spec_verify")


# device -> the one side stream every engine's warm runs and captures
# use: PyTorch keeps a cuBLAS workspace for each stream that ran a
# product, for the life of the process, so a stream per engine would
# leave one behind each engine
_CAPTURE_STREAMS = {}


def capture_stream(device):
    """The device's side stream for warm runs and captures."""
    stream = _CAPTURE_STREAMS.get(device)
    if stream is None:
        stream = _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
    return stream


def _tensors(out):
    return out if isinstance(out, tuple) else (out,)


class Program:
    """One fixed-shape program: ``body(*inputs)`` over the static
    ``inputs`` (device tensors), captured as a CUDA graph on a card.
    ``keep`` holds what the graph reads besides its inputs (weights,
    caches), so that it outlives the graph."""

    def __init__(self, body, inputs, *, pool=None, stream=None, keep=()):
        self.body = body
        self.inputs = tuple(inputs)
        self.cuda = self.inputs[0].device.type == "cuda"
        # pinned host mirrors of the inputs: a copy from them is
        # asynchronous. The engine reads every prefill's, chunk
        # prefill's and decode step's output on the host before it fills
        # a mirror again, and every adopt and gather of a bucket sits
        # between two such reads in one admission, so no mirror is
        # rewritten while its copy is pending.
        self.host = tuple(
            torch.empty(t.shape, dtype=t.dtype).pin_memory() if self.cuda
            else None for t in self.inputs)
        self.pool = pool
        self.stream = stream
        self.keep = keep
        self.graph = None
        self.outputs = None
        self.launches = ()
        self.captured = False

    def _load(self, arrays):
        for arr, host, static in zip(arrays, self.host, self.inputs):
            if isinstance(arr, torch.Tensor):
                static.copy_(arr)  # already a tensor (on the device)
                continue
            src = torch.from_numpy(np.ascontiguousarray(arr))
            if host is None:
                static.copy_(src)
            else:
                host.copy_(src)
                static.copy_(host, non_blocking=True)

    def __call__(self, *arrays):
        """This call's step over ``arrays`` (numpy, one per input): the
        body's outputs (on a card after the first call, the static
        outputs of a replay)."""
        self._load(arrays)
        if not self.captured:
            return self._capture()
        if self.graph is None:
            return self.body(*self.inputs)
        self.graph.replay()
        kernels.add_launches(self.launches)
        return self.outputs

    def _capture(self):
        if not self.cuda:
            self.captured = True
            return self.body(*self.inputs)
        current = torch.cuda.current_stream(self.inputs[0].device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            out = self.body(*self.inputs)
        current.wait_stream(self.stream)
        for t in _tensors(out):
            t.record_stream(current)
        graph = torch.cuda.CUDAGraph()

        def record():
            # no garbage collection inside the capture: a collected cycle
            # that holds another engine's graphs would destroy them there,
            # a call the capture does not permit (it then fails)
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(graph, pool=self.pool,
                                      stream=self.stream):
                    return self.body(*self.inputs)
            finally:
                if collecting:
                    gc.enable()

        self.outputs, self.launches = kernels.measure_launches(record)
        self.graph = graph
        self.captured = True
        return out


class Programs:
    """An engine's program inventory, keyed ``(kind, bucket)`` with kind
    ``"decode"``, ``"prefill"``, ``"adopt"`` or ``"gather"``, or
    ``("chunk", bucket, tail_bucket)``, and the speculative kinds
    (``("spec_verify", width, k1)``, ``("spec_ddecode", row)``,
    ``("spec_dprefill", bucket)``, ``("spec_gather",)``), on one device:
    one memory pool
    for all of them on a card, and the device's capture stream. Counts
    its captures of ``kinds`` under the JAX trace guard's keys, and keeps
    what each program's first call took (``memory``, by program name;
    0 on the CPU): ``graph_pool_bytes``, the growth of the reserved
    device memory across the call from an emptied cache (the capture
    empties it too, ``torch.cuda.graph``); ``peak_bytes``, the most the
    call allocated above what was allocated when it began; and
    ``static_bytes``, its static inputs and outputs. Reading the peak
    resets ``torch.cuda``'s peak statistic at each capture. With a
    ``guard`` (an ``analysis.TraceGuard``), every capture is recorded
    there under its JAX key, the rest of the program key as its
    signature."""

    def __init__(self, device, kinds=BASE_KINDS, guard=None):
        self.device = device
        cuda = device.type == "cuda"
        self.pool = torch.cuda.graph_pool_handle() if cuda else None
        self.stream = capture_stream(device) if cuda else None
        self._progs = {}
        self.counts = dict.fromkeys((TRACE_KEYS[k] for k in kinds), 0)
        self.memory = {}
        self.guard = guard

    def get(self, key):
        """The program ``key``, or None before its first call."""
        return self._progs.get(key)

    def run(self, key, build, *arrays):
        """Call the program ``key`` on ``arrays``; ``build()`` gives its
        ``(body, inputs, keep)`` the first time. A program's first call
        captures it and is counted."""
        prog = self._progs.get(key)
        if prog is None:
            body, inputs, keep = build()
            prog = self._progs[key] = Program(
                body, inputs, pool=self.pool, stream=self.stream, keep=keep)
        fresh = not prog.captured
        if fresh and prog.cuda:
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(self.device)
            allocated = torch.cuda.memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        out = prog(*arrays)
        if fresh:
            self.counts[TRACE_KEYS[key[0]]] += 1
            if self.guard is not None:
                self.guard.record_compile(TRACE_KEYS[key[0]], key[1:],
                                          origin="serving/programs.py")
            entry = dict.fromkeys(("graph_pool_bytes", "peak_bytes",
                                   "static_bytes"), 0)
            if prog.cuda:
                entry["graph_pool_bytes"] = (
                    torch.cuda.memory_reserved(self.device) - reserved)
                entry["peak_bytes"] = torch.cuda.max_memory_allocated(
                    self.device) - allocated
                entry["static_bytes"] = sum(
                    t.numel() * t.element_size()
                    for t in prog.inputs + _tensors(prog.outputs))
            self.memory[NAMES[key[0]].format(*key[1:])] = entry
        return out

    def warm(self, key, build, *arrays):
        """Capture the program ``key`` by a call on ``arrays`` unless it
        is captured already; returns whether it was captured now."""
        prog = self._progs.get(key)
        if prog is not None and prog.captured:
            return False
        self.run(key, build, *arrays)
        return True

    def drop(self, kinds):
        """Forget the programs of these kinds (they are captured again at
        their next call)."""
        for key in [k for k in self._progs if k[0] in kinds]:
            del self._progs[key]
