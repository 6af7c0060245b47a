"""``quantize_for_serving``: real int8 weight-only execution for serving
(counterpart of ``paddle_tpu/quantization/serving.py``).

Every Linear of a model becomes a :class:`QuantizedLinear` that stores
its weight as int8 values and a per-output-channel fp32 scale, as
buffers (not parameters), and runs through the W8A16 matmul
(``kernels/int8_matmul.py``: the hand-written kernel on a CUDA tensor,
its plain version on the CPU) for every input shape.

The pass is idempotent: a QuantizedLinear is never re-rounded. A
PTQ/QAT-converted ``ObservedLayer`` around a Linear keeps its calibrated
per-channel weight scales (``_from_observed``: the weight divided by the
frozen scales, by the same rounding rule); a per-tensor or non-8-bit
observed scale gets fresh per-channel scales from the weight, as a bare
Linear does.
"""
from __future__ import annotations

import copy

import numpy as np
import torch
from torch import nn

from .qat import ObservedLayer, _swap_layers


class QuantizedLinear(nn.Module):
    """Weight-only int8 Linear: ``y = x @ dequant(weight_q, scale) + b``.

    ``weight_q`` (int8 ``[in, out]``) and ``weight_scale`` (fp32
    ``[out]``) are buffers, so optimizers skip them while state dicts and
    ``convert.numpy_state`` carry them."""

    def __init__(self, weight_q, weight_scale, bias=None):
        super().__init__()
        wq = torch.as_tensor(weight_q)
        ws = torch.as_tensor(weight_scale)
        if wq.dtype != torch.int8:
            raise ValueError(f"weight_q must be int8, got {wq.dtype}")
        if wq.dim() != 2 or tuple(ws.shape) != (int(wq.shape[1]),):
            raise ValueError(
                f"expected weight_q [in, out] with per-out-channel scale "
                f"[out]; got {tuple(wq.shape)} / {tuple(ws.shape)}"
            )
        self.in_features = int(wq.shape[0])
        self.out_features = int(wq.shape[1])
        self.register_buffer("weight_q", wq.contiguous())
        self.register_buffer("weight_scale", ws.to(
            device=wq.device, dtype=torch.float32).contiguous())
        if bias is not None:
            self.register_buffer("bias", torch.as_tensor(bias).detach()
                                 .to(wq.device))
        else:
            self.bias = None

    def forward(self, x):
        from ..kernels.int8_matmul import int8_matmul

        y = int8_matmul(x, self.weight_q, self.weight_scale)
        if self.bias is not None:
            y = y + self.bias
        return y

    def extra_repr(self):
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}, dtype=int8")


def quantize_linear_weight(weight):
    """Float ``[in, out]`` weight -> (int8 values, fp32 ``[out]``
    per-output-channel scales), by the kernel module's rounding rule."""
    from ..kernels.int8_matmul import quantize_weight

    return quantize_weight(weight.detach())


def _requantize_with_scales(weight, scales):
    """Quantize ``[in, out]`` with calibrated per-channel scales (the
    PTQ/QAT observed absmax path: the weight divided by the frozen
    scales instead of fresh ones; the rounding rule itself is
    ``kernels/int8_matmul.quantize_weight_with_scales``)."""
    from ..kernels.int8_matmul import quantize_weight_with_scales

    w = weight.detach()
    return quantize_weight_with_scales(
        w, torch.as_tensor(np.asarray(scales, np.float32), device=w.device))


def _is_linear(layer):
    from ..nn import Linear

    return isinstance(layer, Linear)


def _from_linear(lin):
    with torch.no_grad():
        wq, ws = quantize_linear_weight(lin.weight)
    return QuantizedLinear(wq, ws, bias=getattr(lin, "bias", None))


def _from_observed(obs):
    inner = obs._inner
    if not _is_linear(inner):
        return None
    ws = obs.weight_scale
    per_channel = (
        ws is not None
        and int(obs.weight_bits) == 8
        and np.ndim(ws) == 1
        and np.shape(ws)[0] == int(inner.weight.shape[-1])
    )
    if per_channel:
        with torch.no_grad():
            wq, s = _requantize_with_scales(inner.weight, ws)
        return QuantizedLinear(wq, s, bias=getattr(inner, "bias", None))
    # per-tensor or non-8-bit observed scales: fresh per-channel absmax
    # (tighter than a per-tensor scale)
    return _from_linear(inner)


def quantize_for_serving(model, inplace=False):
    """Convert every Linear's weight (and every PTQ/QAT ``ObservedLayer``
    around one, with its calibrated scales) to an (int8, scale) pair run
    by the W8A16 kernel. Returns the converted model (a deep copy unless
    ``inplace=True``; in place, the float weights are freed as their
    layers are swapped, so the peak stays near the float model's size).
    Calling it again on the result changes nothing."""
    if not inplace:
        model = copy.deepcopy(model)

    def make(layer):
        if isinstance(layer, QuantizedLinear):
            return None  # idempotence: int8 weights are never re-rounded
        if isinstance(layer, ObservedLayer):
            return _from_observed(layer)
        if _is_linear(layer):
            return _from_linear(layer)
        return None

    return _swap_layers(model, make)
