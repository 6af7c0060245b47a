"""``CompiledTrainStep``: one optimizer step per call (counterpart of
``paddle_tpu/jit/trainer.py``).

The name is the JAX package's, so a reader finds the counterpart; here
the step runs eagerly (capturing it in a CUDA graph around the hand
kernels is later work). Each call runs, in the order of the JAX step
(``trainer.py:319-500``):

1. the forward and the loss, under the O1 casts when ``amp_level`` is
   "O1" or "O2" (O2 behaves as O1 inside the step, as in the JAX
   trainer: the parameters stay fp32);
2. the backward through torch autograd (the RMSNorm, rope and flash
   attention kernels' backward kernels on the card);
3. ``optimizer.step()``: the optimizer's clip, then its update of EVERY
   parameter it owns (a parameter the loss does not reach gets a zero
   gradient, as ``jax.value_and_grad`` gives it).

The scheduler is not stepped here; the caller steps it, as in the JAX
package. Returns ``(loss, outputs)``: the fp32 loss and the network's
outputs, detached. Nothing is read back to the host.
"""
from __future__ import annotations

import contextlib

import torch

from .. import optimizer as opt_mod
from ..amp.auto_cast import auto_cast


class CompiledTrainStep:
    """Build once per (network, loss, optimizer); call with batches."""

    SUPPORTED = (opt_mod.AdamW, opt_mod.Adam)

    def __init__(self, network, loss_fn, optimizer, amp_level=None,
                 amp_dtype="bfloat16"):
        if not any(type(optimizer) is cls for cls in self.SUPPORTED):
            raise NotImplementedError(
                f"CompiledTrainStep does not support "
                f"{type(optimizer).__name__}; it takes "
                f"{', '.join(c.__name__ for c in self.SUPPORTED)}"
            )
        if amp_level not in (None, "O0", "O1", "O2"):
            raise NotImplementedError(
                f"amp_level {amp_level!r} is not ported (None, O0, O1, O2)")
        self.network = network
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.amp_level = amp_level
        self.amp_dtype = amp_dtype

    def _amp(self):
        if self.amp_level in ("O1", "O2"):
            return auto_cast(True, level=self.amp_level,
                             dtype=self.amp_dtype)
        return contextlib.nullcontext()

    def __call__(self, inputs, labels):
        """One optimizer step over ``inputs`` (the network's positional
        arguments) and ``labels`` (the loss function's arguments after
        the network's outputs)."""
        opt = self.optimizer
        opt.clear_grad()
        self.network.train()
        with self._amp():
            out = self.network(*inputs)
            outs = list(out) if isinstance(out, (list, tuple)) else [out]
            loss = self.loss_fn(*outs, *labels).float()
        loss.backward()
        for _, p in opt._all_params():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        opt.step()
        opt.clear_grad()
        return loss.detach(), [o.detach() for o in outs]
