"""``quantize_for_serving``: real int8 weight-only execution for serving
(counterpart of ``paddle_tpu/quantization/serving.py``).

Every Linear of a model becomes a :class:`QuantizedLinear` that stores
its weight as int8 values and a per-output-channel fp32 scale, as
buffers (not parameters), and runs through the W8A16 matmul
(``kernels/int8_matmul.py``: the hand-written kernel on a CUDA tensor,
its plain version on the CPU) for every input shape.

The pass is idempotent: a QuantizedLinear is never re-rounded. PTQ and
QAT (``ObservedLayer`` and its calibrated scales, ``_from_observed``)
are not ported; a model holding such a layer is refused.
"""
from __future__ import annotations

import copy

import torch
from torch import nn

PTQ_QAT_NOT_PORTED = (
    "PTQ/QAT ObservedLayer conversion (_from_observed) is not ported yet: "
    "ROADMAP.md queue A item 3"
)


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


def _from_linear(lin):
    with torch.no_grad():
        wq, ws = quantize_linear_weight(lin.weight)
    return QuantizedLinear(wq, ws, bias=getattr(lin, "bias", None))


def _swap_layers(model, make):
    """Replace matching submodules in place (``qat.py:86``); does not
    recurse into a QuantizedLinear."""
    for name, child in list(model.named_children()):
        replacement = make(child)
        if replacement is not None:
            setattr(model, name, replacement)
        elif not isinstance(child, QuantizedLinear):
            _swap_layers(child, make)
    return model


def quantize_for_serving(model, inplace=False):
    """Convert every Linear's weight to an (int8, scale) pair run by the
    W8A16 kernel. Returns the converted model (a deep copy unless
    ``inplace=True``; in place, the float weights are freed as their
    layers are swapped, so the peak stays near the float model's size).
    Calling it again on the result changes nothing."""
    from ..nn import Linear

    if not inplace:
        model = copy.deepcopy(model)

    def make(layer):
        if isinstance(layer, QuantizedLinear):
            return None  # idempotence: int8 weights are never re-rounded
        if type(layer).__name__ == "ObservedLayer":
            raise NotImplementedError(PTQ_QAT_NOT_PORTED)
        if isinstance(layer, Linear):
            return _from_linear(layer)
        return None

    return _swap_layers(model, make)
