"""The NaN/Inf sweep (``FLAGS_check_nan_inf``) and the per-op seam that
the operator statistics share.

Counterpart of ``paddle_tpu/core/dispatch.py:50-90`` (``check_nan_inf``,
``_nan_report``, the ``_NANINF_HOOK`` slot), called there for every op's
outputs (``:201``, ``:220``) and every backward node's
(``autograd/backward.py:112``). The port has no dispatcher of its own, so
the seam is a ``TorchDispatchMode`` that sees every ATen op of the
thread it is pushed on:

- a forward op is named by its ATen packet (``aten.sqrt.default`` ->
  ``sqrt``; ``mul``, ``div`` and ``sub`` by the reference's names,
  ``multiply``, ``divide``, ``subtract``);
- an op run by the autograd engine is named after the node that runs it,
  as JAX names its backward nodes: ``<op>_grad`` (``SqrtBackward0`` ->
  ``sqrt_grad``);
- a hand-written kernel bypasses ATen (a ctypes launch), so its wrapper
  calls :func:`kernel_op`, which checks the kernel's outputs under the
  name JAX's dispatch gives the op (``fused_rms_norm``, ``fused_rope``,
  ``flash_attention``; backward ``<name>_grad``) and hides the ATen ops
  inside the call (a CPU tensor's plain version) from the seam.

Views, copies, casts and allocations are not ops here (their outputs
hold what another op wrote; ``torch.empty`` holds garbage), nor is an op
without a tensor input (a factory).

Eager, a non-finite output raises at the op with JAX's message, one
read-back per op as JAX's eager ``bool(ok)``. Inside :func:`deferred`
(``jit.CompiledTrainStep``) each op's finite flag stays on the device and
:meth:`Deferred.check` reads them all once, then raises naming the first
op that failed, as JAX's traced check raises when the step executes.
Before raising, the flight recorder's slot
(``observability.flight_recorder.NANINF_HOOK``) is called with the op's
name.

The seam is pushed on a thread by :func:`set_flags` (the calling
thread) and by :func:`ensure` at the port's entry points (the model's
forward and the train step), and taken off there once the flag and the
collector are both off: with both off an entry point costs one flag
read.
"""
from __future__ import annotations

import re
import threading
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..observability import flight_recorder as _fr
from ..utils import flags as _flags

# [sweep or statistics on]: the one read an entry point makes
_ON = [False]
# [FLAGS_check_nan_inf]
_CHECK = [False]
# [callable(op name, seconds)] of the operator statistics, or [None]
_COLLECTOR = [None]
# [the open compiled step's Deferred, or None]: one for every thread, so
# that the backward, which the autograd engine runs on a device thread of
# its own on a card, defers into the step's flags too
_DEFERRED = [None]

# ops that compute nothing of their own: their outputs hold what another
# op wrote (or garbage: torch.empty)
_NOT_OPS = frozenset({
    "_to_copy", "copy_", "clone", "detach", "lift_fresh",
    "lift_fresh_copy", "_unsafe_view", "contiguous", "alias", "set_",
    "resize_", "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "_local_scalar_dense", "to", "_copy_from",
    "_copy_from_and_resize",
})
# the reference's names where ATen's differ
_ALIASES = {"mul": "multiply", "div": "divide", "sub": "subtract"}


class _State(threading.local):
    def __init__(self):
        self.mode = None      # the seam pushed on this thread
        self.quiet = 0        # inside a hand kernel's wrapper


_T = _State()


def _refresh():
    _CHECK[0] = bool(_flags.flag("FLAGS_check_nan_inf"))
    _ON[0] = _CHECK[0] or _COLLECTOR[0] is not None
    ensure()


def ensure():
    """Push the seam on the calling thread when the flag (or the
    collector) is on, take it off when both are off: the entry points'
    one read."""
    if _ON[0]:
        if _T.mode is None:
            _T.mode = _Seam()
            _T.mode.__enter__()
    elif _T.mode is not None:
        mode, _T.mode = _T.mode, None
        mode.__exit__(None, None, None)


def _snake(name):
    return re.sub(r"(?<=[a-z0-9])(?=[A-Z])", "_", name).lower()


def node_op_name(node):
    """The backward op's name of autograd ``node``: ``SqrtBackward0`` ->
    ``sqrt_grad`` (a hand kernel's backward names itself:
    :func:`kernel_op`)."""
    base = re.sub(r"Backward\d*$", "", node.name().rsplit("::", 1)[-1])
    base = _snake(base.lstrip("_"))
    return _ALIASES.get(base, base) + "_grad"


def op_name(func):
    """The forward name of ATen op ``func``: its packet's name."""
    base = func._opname
    return _ALIASES.get(base, base)


def _floats(out):
    if isinstance(out, torch.Tensor):
        return [out] if out.is_floating_point() else []
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _floats(o)]
    return []


def report(name):
    """Fire the flight recorder's slot, then raise JAX's error."""
    hook = _fr.NANINF_HOOK[0]
    if hook is not None:
        try:
            hook(name)
        except Exception:
            pass  # a broken recorder must not mask the NaN error
    raise RuntimeError(
        f"FLAGS_check_nan_inf: operator [{name}] output contains NaN or Inf")


def check(name, out):
    """Check every floating tensor of ``out`` (eager: raises at once;
    inside :func:`deferred`: keeps the flags on the device)."""
    ts = [t for t in _floats(out) if t.numel()]
    if not ts:
        return
    d = _DEFERRED[0]
    _T.quiet += 1  # the check's own ops are not ops of the program
    try:
        with torch.no_grad():
            # fp8 codes have no isfinite: they are checked as floats
            oks = [torch.isfinite(t.float() if t.element_size() == 1 else t)
                   .all() for t in ts]
        if d is not None:
            d.flags.extend((name, ok) for ok in oks)
            return
        bad = [not bool(ok) for ok in oks]
    finally:
        _T.quiet -= 1
    if any(bad):
        report(name)


def kernel_op(name, fn, *args):
    """``fn(*args)``, a hand kernel's wrapper (or its plain version on the
    CPU), as one op named ``name`` (``<name>_grad`` inside the autograd
    engine): its outputs checked, its inner ATen ops hidden."""
    if not _ON[0]:
        return fn(*args)
    if torch._C._current_autograd_node() is not None:
        name += "_grad"
    _T.quiet += 1
    t0 = time.perf_counter()
    try:
        out = fn(*args)
    finally:
        _T.quiet -= 1
    col = _COLLECTOR[0]
    if col is not None and not name.endswith("_grad"):
        col(name, time.perf_counter() - t0)
    if _CHECK[0]:
        check(name, out)
    return out


def _is_op(func, args, kwargs):
    if func.is_view or func._opname in _NOT_OPS:
        return False
    return any(isinstance(a, torch.Tensor) for a in args) or any(
        isinstance(a, torch.Tensor) for a in kwargs.values())


class _Seam(TorchDispatchMode):
    """Every ATen op of its thread: timed for the collector, its
    floating outputs checked while the flag is on."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _T.quiet or not _ON[0] or not _is_op(func, args, kwargs):
            return func(*args, **kwargs)
        col = _COLLECTOR[0]
        t0 = time.perf_counter()
        out = func(*args, **kwargs)
        node = torch._C._current_autograd_node()
        if node is None:
            if col is not None:
                col(op_name(func), time.perf_counter() - t0)
            if _CHECK[0]:
                check(op_name(func), out)
        elif _CHECK[0] and "AccumulateGrad" not in node.name():
            # a gradient accumulated into .grad was checked where it was
            # made
            check(node_op_name(node), out)
        return out


class Deferred:
    """The finite flags of one compiled step's ops, read once by
    :meth:`check`."""

    def __init__(self):
        self.flags = []

    def check(self):
        """One read-back: raise naming the first op whose output was not
        finite."""
        flags, self.flags = self.flags, []
        if not flags:
            return
        dev = flags[0][1].device
        _T.quiet += 1
        try:
            ok = torch.stack([f.to(dev) for _, f in flags]).cpu()
        finally:
            _T.quiet -= 1
        if not bool(ok.all()):
            report(flags[int((~ok).nonzero()[0, 0])][0])


class deferred:
    """``with deferred() as d: ...; d.check()``: inside, the sweep keeps
    each op's flag on the device instead of reading it back, on every
    thread (the autograd engine's too); None when the flag is off:
    nothing to read."""

    def __enter__(self):
        if not _CHECK[0]:
            self.d = None
            return None
        ensure()
        self.prev, self.d = _DEFERRED[0], Deferred()
        _DEFERRED[0] = self.d
        return self.d

    def __exit__(self, *exc):
        if self.d is not None:
            _DEFERRED[0] = self.prev
        return False


def set_collector(fn):
    """Install ``fn(op name, seconds)`` as the per-op collector (None:
    off); returns the previous one."""
    prev, _COLLECTOR[0] = _COLLECTOR[0], fn
    _refresh()
    return prev


_flags.on_change(_refresh)
