"""Gradient clipping by global norm (counterpart of
``paddle_tpu/optimizer/clip.py`` ``ClipGradByGlobalNorm`` and of its
in-step form in the compiled trainer, ``trainer.py:436-452``).

The norm is taken in fp32 over every gradient, ``coef = min(1,
clip_norm / max(gnorm, 1e-12))``, and each gradient is scaled in fp32
and cast back to its dtype. Everything stays on the device: no value is
read back to the host.
"""
from __future__ import annotations

import torch


class ClipGradByGlobalNorm:
    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def clip(self, grads):
        """``grads`` (None entries kept) scaled by the clip coefficient."""
        sq = None
        for g in grads:
            if g is not None:
                s = torch.sum(torch.square(g.float()))
                sq = s if sq is None else sq + s
        if sq is None:
            return list(grads)
        coef = torch.clamp(
            self.clip_norm / torch.clamp(torch.sqrt(sq), min=1e-12), max=1.0)
        return [None if g is None else (g.float() * coef).to(g.dtype)
                for g in grads]
