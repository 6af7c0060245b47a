"""Device-to-host snapshots that do not block the train loop (counterpart
of ``paddle_tpu/checkpoint/snapshot.py``).

The JAX package copies each device leaf on the device (``jnp.copy``) so
that a save survives the next step's buffer donation. The port has no
donation, but a worse hazard: the multi-tensor updates
(``kernels/fused_adam.py``) write the parameters and the optimizer's
moments IN PLACE, so a background writer reading the live tensors after
the next step began would write a torn, mixed-step checkpoint.

:func:`snapshot_state` therefore copies every CUDA leaf into one pinned
host buffer on a side stream, which first waits for the work already
queued on the caller's stream (the step that just ended), and records an
event after the copies. The copies then run beside whatever the caller
queues next. Whoever writes those tensors in place next must wait on the
event first: :meth:`Snapshot.fence` makes the caller's current stream
wait on it (``torch.cuda.current_stream().wait_event``). The trainer
calls it just before its optimizer update, so the copy overlaps the next
step's forward and backward; a snapshot taken with ``fence_now=True``
fences at once. The writer thread waits on the event
(:meth:`Snapshot.wait`) before it serializes.

CPU leaves (CPU tensors, numpy arrays) are copied at once; python
scalars are kept.
"""
from __future__ import annotations

import numpy as np
import torch

# each leaf's offset in the pinned buffer is a multiple of this
_ALIGN = 64


class Snapshot(dict):
    """A snapshot of a state dict: the parallel structure with host
    tensors (views of one pinned buffer) for the device leaves, the side
    stream of their copies and the event that marks them done (None when
    nothing was on a card)."""

    def __init__(self, items, event=None, stream=None):
        super().__init__(items)
        self.event = event
        self.stream = stream

    def fence(self):
        """Make the caller's current CUDA stream wait until every copy is
        done (before it writes a snapshotted tensor in place). Idempotent
        and cheap: one ``wait_event`` on the device."""
        if self.event is not None:
            torch.cuda.current_stream(self.stream.device).wait_event(
                self.event)

    def wait(self):
        """Block the host until every copy is done (the writer thread)."""
        if self.event is not None:
            self.event.synchronize()


def _leaves(state):
    if isinstance(state, dict):
        for v in state.values():
            yield from _leaves(v)
    elif isinstance(state, (list, tuple)):
        for v in state:
            yield from _leaves(v)
    else:
        yield state


def _is_cuda(v):
    return isinstance(v, torch.Tensor) and v.device.type == "cuda"


def _copy(state, take):
    if isinstance(state, dict):
        return {k: _copy(v, take) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return [_copy(v, take) for v in state]
    if _is_cuda(state):
        return take(state)
    if isinstance(state, torch.Tensor):
        return state.detach().clone()
    if isinstance(state, np.ndarray):
        return np.array(state, copy=True)
    return state


def snapshot_state(state, fence_now=False):
    """Copy a (possibly nested) state dict into snapshot form: CUDA
    leaves into one pinned host buffer on a side stream (every card leaf
    must be on one device), host leaves now. Returns a :class:`Snapshot`
    with the parallel structure. ``fence_now`` fences the caller's
    stream at once (for callers with no hook before their next in-place
    write)."""
    cuda = [v for v in _leaves(state) if _is_cuda(v)]
    if not cuda:
        return Snapshot(_copy(state, None))
    device = cuda[0].device
    total = 0
    for v in cuda:
        total += -(-v.numel() * v.element_size() // _ALIGN) * _ALIGN
    buffer = torch.empty((total,), dtype=torch.uint8, pin_memory=True)
    current = torch.cuda.current_stream(device)
    stream = torch.cuda.Stream(device)
    stream.wait_stream(current)
    offset = [0]

    def take(t):
        n = t.numel() * t.element_size()
        dst = buffer[offset[0]:offset[0] + n].view(t.dtype).view(t.shape)
        offset[0] += -(-n // _ALIGN) * _ALIGN
        dst.copy_(t.detach(), non_blocking=True)
        # the source may be freed on its own stream meanwhile
        t.record_stream(stream)
        return dst

    with torch.cuda.stream(stream):
        items = _copy(state, take)
        event = torch.cuda.Event()
        event.record(stream)
    snap = Snapshot(items, event=event, stream=stream)
    if fence_now:
        snap.fence()
    return snap


def snapshot_is_ready(snap):
    """True when every device-to-host copy of the snapshot is done (the
    writer may serialize without blocking)."""
    event = getattr(snap, "event", None)
    return event is None or event.query()


def snapshot_nbytes(snap):
    """Payload size: the bytes of every tensor and array leaf."""
    total = 0
    for v in _leaves(snap):
        if isinstance(v, torch.Tensor):
            total += v.numel() * v.element_size()
        elif isinstance(v, np.ndarray):
            total += v.nbytes
    return total
