"""Live weight reload: a committed checkpoint swapped into a RUNNING engine
(counterpart of ``paddle_tpu/serving/reload.py``).

1. **Verify**: the candidate directory must pass the manifest and CRC
   protocol (``checkpoint.commit.verify_checkpoint``); a torn or
   bit-rotted publish is refused and the engine keeps serving.
2. **Load**: the checkpoint's ``model`` state loads into staging tensors
   of the prepare's own, shaped like the engine's parameters and buffers
   or like a template net's (``template_net``: an instance or a zero-arg
   factory; an instance is never written). When the engine serves
   QUANTIZED weights and the template is a float net, the checkpoint
   loads into a copy of it that
   ``quantization.serving.quantize_for_serving`` converts: a float
   training checkpoint publishes as int8 serving weights.
3. **Validate**: the staged tensors must match the engine's parameters
   and buffers key for key in shape and dtype; an incompatible
   checkpoint is refused.
4. **Apply at a step boundary**: the engine applies a committed swap only
   when NO request is in flight; admission pauses meanwhile, so every
   request runs start to finish under one weights version.

Steps 1-3 (:func:`prepare_state_swap`) are pure and may run off the
engine's thread, as JAX's do. Every outcome is counted in the engine's
``metrics.reloads`` by label; the admission pause lands in
``metrics.reload_ttft_spike``.

Where the port departs (``ROADMAP.md`` queue C): the engines' programs
are CUDA graphs that hold their weights' addresses, so the swap COPIES
the staged tensors into the engine's existing parameter and buffer
storage (``copy_`` on the engine's stream) instead of rebinding arrays;
no program is captured again. The staged tensors wait on the device, as
JAX's staged arrays do, so the pause is one device-to-device copy: the
disk read and the host-to-device copies run on the preparing thread on
a side stream, which records an event that the apply makes the engine's
stream wait on. Staging needs room for a second copy of the weights; a
prepare that finds less free device memory returns ``load_error`` naming
the bytes needed and free. Capturing a program while another thread
prepares is not supported (a capture forbids other threads' CUDA work):
prepare concurrently only on a warmed engine.
"""
from __future__ import annotations

import contextlib
import copy
import logging
import os
import time

import torch

from .. import chaos as _chaos

logger = logging.getLogger("paddle_tpu_torch.serving.reload")


class ReloadError(RuntimeError):
    """Programming-error side of reload (bad arguments); operational
    failures (torn checkpoint, incompatible state) come back as a failed
    :class:`StagedReload`, never an exception."""


class StagedReload:
    """A prepared (verified, loaded, validated) weight swap, plus its
    outcome trail once committed/applied. ``event`` marks the staged
    tensors' copies done (None off a card); ``timings`` holds the
    prepare's seconds (``verify_s``, ``read_s``, ``copy_s``,
    ``prepare_s``) and ``bytes`` read."""

    __slots__ = ("ok", "outcome", "error", "params", "buffers",
                 "weights_version", "step", "path", "staged_at", "event",
                 "timings")

    def __init__(self, ok, outcome, *, error=None, params=None,
                 buffers=None, weights_version=None, step=None,
                 path=None, event=None, timings=None):
        self.ok = bool(ok)
        self.outcome = outcome
        self.error = error
        self.params = params
        self.buffers = buffers
        self.weights_version = weights_version
        self.step = step
        self.path = path
        self.staged_at = None
        self.event = event
        self.timings = timings if timings is not None else {}

    @property
    def applied(self):
        return self.outcome == "applied"

    def to_json(self):
        return {
            "ok": self.ok,
            "outcome": self.outcome,
            "error": self.error,
            "weights_version": self.weights_version,
            "step": self.step,
            "path": self.path,
        }

    def __repr__(self):
        return (f"StagedReload(ok={self.ok}, outcome={self.outcome!r}, "
                f"version={self.weights_version!r}, step={self.step})")


def resolve_checkpoint_dir(path):
    """``path`` may be a committed step directory (has a manifest) or a
    checkpoint ROOT: then the newest committed step is chosen, as restore
    chooses. Returns None when nothing committed exists."""
    from ..checkpoint import commit as commit_mod

    path = str(path)
    if commit_mod.read_manifest(path) is not None:
        return path
    if os.path.isdir(path):
        return commit_mod.latest_committed(path)
    return None


def _is_quantized(net):
    from ..quantization.serving import QuantizedLinear

    return any(isinstance(m, QuantizedLinear) for m in net.modules())


def _harvest(net):
    return (dict(net.named_parameters()), dict(net.named_buffers()))


def _validate(cur_params, cur_buffers, new_params, new_buffers):
    """Key/shape/dtype compatibility of the staged tensors against the
    engine's. Returns a problem string or None."""
    for kind, cur, new in (("param", cur_params, new_params),
                           ("buffer", cur_buffers, new_buffers)):
        missing = sorted(set(cur) - set(new))
        extra = sorted(set(new) - set(cur))
        if missing or extra:
            return (f"{kind} keys differ: missing {missing[:3]}, "
                    f"unexpected {extra[:3]}")
        for k, v in cur.items():
            nv = new[k]
            if tuple(nv.shape) != tuple(v.shape):
                return (f"{kind} {k}: shape {tuple(nv.shape)} != "
                        f"serving {tuple(v.shape)}")
            if nv.dtype != v.dtype:
                return (f"{kind} {k}: dtype {nv.dtype} != serving "
                        f"{v.dtype}")
    return None


def _nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _room(device, need):
    """None when ``need`` bytes fit on ``device`` (free memory plus what
    the caching allocator holds unused), else the refusal's message."""
    if device.type != "cuda":
        return None
    free, _total = torch.cuda.mem_get_info(device)
    free += (torch.cuda.memory_reserved(device)
             - torch.cuda.memory_allocated(device))
    if need <= free:
        return None
    return (f"staging the weights needs {need} bytes of device memory, "
            f"{free} free")


def prepare_state_swap(net, cur_params, cur_buffers, ckpt_dir, *,
                       weights_version=None, template_net=None,
                       verify_level="full"):
    """The prepare path: verify -> load (-> quantize) -> validate. Pure:
    touches neither ``net``, the current tensors nor ``template_net``;
    the staged tensors are its own. Returns a :class:`StagedReload`
    either way."""
    from ..checkpoint import commit as commit_mod
    from ..distributed.checkpoint.save_load import load_state_dict

    t_start = time.perf_counter()
    try:
        _chaos.poke("reload.prepare", path=str(ckpt_dir))
    except BaseException as e:
        return StagedReload(False, "error", error=repr(e),
                            path=str(ckpt_dir))
    path = resolve_checkpoint_dir(ckpt_dir)
    if path is None:
        return StagedReload(
            False, "no_checkpoint",
            error=f"no committed checkpoint under {ckpt_dir!r}",
            path=str(ckpt_dir),
        )
    t0 = time.perf_counter()
    problems = commit_mod.verify_checkpoint(path, level=verify_level)
    timings = {"verify_s": time.perf_counter() - t0}
    if problems:
        logger.warning("reload: refusing %s: %s", path, problems[:4])
        return StagedReload(
            False, "verify_failed",
            error="; ".join(problems[:4]), path=path, timings=timings,
        )
    manifest = commit_mod.read_manifest(path)
    step = int(manifest["step"])
    quantized = _is_quantized(net)
    device = next(iter(cur_params.values())).device
    cuda = device.type == "cuda"
    stream = torch.cuda.Stream(device) if cuda else None
    event = None
    try:
        # a template may be a net INSTANCE or a zero-arg factory; a
        # Module is itself callable, so only non-Module callables are
        # factories. Resolution sits inside the try: a throwing factory
        # is a load_error, never an escape.
        if template_net is not None and callable(template_net) \
                and not isinstance(template_net, torch.nn.Module):
            template = template_net()
        else:
            template = template_net
        problem = _room(device, _nbytes(
            list(cur_params.values()) + list(cur_buffers.values())))
        if problem is not None:
            return StagedReload(False, "load_error", error=problem,
                                path=path, step=step, timings=timings)
        with torch.cuda.stream(stream) if cuda else contextlib.nullcontext():
            if template is not None and quantized \
                    and not _is_quantized(template):
                # the int8 publish path: a float training checkpoint
                # becomes serving-format weights inside the swap. It
                # loads into a private copy of a template instance (a
                # factory's net is private already), never the template
                from ..quantization.serving import quantize_for_serving

                work = (copy.deepcopy(template) if template is template_net
                        else template)
                load_state_dict({"model": work.state_dict()}, path,
                                timings=timings)
                new_params, new_buffers = _harvest(
                    quantize_for_serving(work, inplace=True))
                new_params = {k: v.detach().to(device)
                              for k, v in new_params.items()}
                new_buffers = {k: v.detach().to(device)
                               for k, v in new_buffers.items()}
            else:
                # staging tensors of their own on the engine's device,
                # shaped like the template's or, with none, the
                # engine's: neither is ever written, so a later prepare
                # cannot change a swap already staged
                like_params, like_buffers = (
                    _harvest(template) if template is not None
                    else (cur_params, cur_buffers))
                tmpl = {k: torch.empty_like(v, device=device) for k, v in
                        {**like_params, **like_buffers}.items()}
                load_state_dict({"model": tmpl}, path, timings=timings)
                new_params = {k: tmpl[k] for k in like_params}
                new_buffers = {k: tmpl[k] for k in like_buffers}
            if cuda:
                event = torch.cuda.Event()
                event.record(stream)
    except KeyError as e:
        hint = (" (engine serves quantized weights: pass a "
                "float-architecture template_net so the checkpoint "
                "can be quantized inside the swap)"
                if quantized and template_net is None else "")
        return StagedReload(
            False, "incompatible",
            error=f"checkpoint does not match serving net: {e}{hint}",
            path=path, step=step, timings=timings,
        )
    except Exception as e:
        return StagedReload(
            False, "load_error", error=repr(e), path=path, step=step,
            timings=timings,
        )
    problem = _validate(cur_params, cur_buffers, new_params, new_buffers)
    if problem is not None:
        return StagedReload(
            False, "incompatible", error=problem, path=path, step=step,
            timings=timings,
        )
    version = (str(weights_version) if weights_version is not None
               else f"ckpt-{step}")
    timings["prepare_s"] = time.perf_counter() - t_start
    return StagedReload(
        True, "staged", params=new_params, buffers=new_buffers,
        weights_version=version, step=step, path=path, event=event,
        timings=timings,
    )




def apply_state_swap(staged, cur_params, cur_buffers):
    """Copy the staged tensors into the engine's parameter and buffer
    storage, in place, on the caller's current stream (after waiting on
    the staging event), then release the staged tensors."""
    stream = None
    if staged.event is not None:
        device = next(iter(cur_params.values())).device
        stream = torch.cuda.current_stream(device)
        stream.wait_event(staged.event)
    with torch.no_grad():
        for cur, new in ((cur_params, staged.params),
                         (cur_buffers, staged.buffers)):
            for k, t in cur.items():
                src = new[k]
                t.copy_(src)
                if stream is not None:
                    # staged on the side stream: not freed for reuse
                    # before this copy has read it
                    src.record_stream(stream)
    staged.params = staged.buffers = None
