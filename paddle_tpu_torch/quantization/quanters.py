"""Fake quanters: quantize, round and dequantize in the graph with a
straight-through estimator (counterpart of
``paddle_tpu/quantization/quanters.py``)."""
from __future__ import annotations

import torch

from ..amp import naninf as _naninf
from .observers import _ObserverFactory


def _fake_quant(x, scale, qmax):
    # JAX promotes x with the fp32 scale (a bf16 x computes in fp32)
    x = x.to(torch.promote_types(x.dtype, torch.float32))
    q = torch.clamp(torch.round(x / scale), -qmax - 1, qmax)
    dq = q * scale
    # straight-through estimator: the value dq (as x + (dq - x), the bits
    # JAX's forward gives), the gradient the identity
    return x + (dq - x).detach()


def fake_quant(x, scale, quant_bits=8):
    """Simulate b-bit symmetric quantization of ``x`` with ``scale`` (a
    number, an array or a tensor: fp32 on x's device); one op of the
    NaN/Inf sweep, ``fake_quant``."""
    if not isinstance(scale, torch.Tensor):
        scale = torch.as_tensor(scale, dtype=torch.float32)
    scale = scale.to(device=x.device, dtype=torch.float32)
    qmax = float(2 ** (int(quant_bits) - 1) - 1)
    return _naninf.kernel_op("fake_quant", _fake_quant, x, scale, qmax)


class _FakeQuanter:
    """A moving-average absmax scale and the STE fake quant (QAT's
    quanter). Stateful, as the reference's: the scale is part of the
    layer's quant state, kept in Python floats."""

    def __init__(self, quant_bits=8, moving_rate=0.9):
        self.quant_bits = int(quant_bits)
        self._qmax = float(2 ** (self.quant_bits - 1) - 1)
        self.moving_rate = float(moving_rate)
        self._state = 0.0
        self._initialized = False

    def scale(self):
        return max(self._state, 1e-8) / self._qmax

    def __call__(self, x):
        with torch.no_grad():
            cur = float(x.detach().abs().amax()) if x.numel() else 0.0
        if not self._initialized:
            self._state = cur
            self._initialized = True
        else:
            self._state = (
                self.moving_rate * self._state
                + (1.0 - self.moving_rate) * cur
            )
        return fake_quant(x, self.scale(), self.quant_bits)


def FakeQuanterWithAbsMaxObserver(quant_bits=8, moving_rate=0.9):
    return _ObserverFactory(
        _FakeQuanter, quant_bits=quant_bits, moving_rate=moving_rate
    )
