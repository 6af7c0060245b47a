"""Observers: track activation and weight ranges to derive int8 scales
(counterpart of ``paddle_tpu/quantization/observers.py``).

The ranges are reduced where the tensor lives (the card's |x| max is
exact, as numpy's is) and only the result comes to the host. The scales
are computed as JAX computes them, so they come out bit-equal: the
per-tensor scale in Python floats (float64, rounded to fp32 only where
``fake_quant`` wraps it), the per-channel scales in numpy float32.
"""
from __future__ import annotations

import numpy as np
import torch


class _ObserverFactory:
    """The config holds a factory; one observer is made per observed
    tensor through ``_instance()``."""

    def __init__(self, cls, **kw):
        self._cls = cls
        self._kw = kw

    def _instance(self):
        return self._cls(**self._kw)


def _absmax(value, axes=None):
    """``max |value|`` (over ``axes``, or all of it): a Python float, or a
    numpy float32 array (a tensor is reduced on its device)."""
    if isinstance(value, torch.Tensor):
        v = value.detach().float().abs()
        if axes is None:
            return float(v.amax()) if v.numel() else 0.0
        return (v.amax(dim=axes) if axes else v).cpu().numpy()
    v = np.abs(np.asarray(value))
    if axes is None:
        return float(v.max(initial=0.0))
    return v.max(axis=axes) if axes else v


class BaseObserver:
    def __init__(self, quant_bits=8):
        self.quant_bits = int(quant_bits)
        self._qmax = float(2 ** (self.quant_bits - 1) - 1)

    def observe(self, value):
        raise NotImplementedError

    def scales(self):
        raise NotImplementedError


class _AbsmaxObserver(BaseObserver):
    """Running max of |x| over observed batches -> a per-tensor scale."""

    def __init__(self, quant_bits=8):
        super().__init__(quant_bits)
        self._absmax = 0.0

    def observe(self, value):
        self._absmax = max(self._absmax, _absmax(value))

    def scales(self):
        return max(self._absmax, 1e-8) / self._qmax


class _PerChannelAbsmaxObserver(BaseObserver):
    """Per-output-channel |w| max (weights; the channel axis is
    configurable)."""

    def __init__(self, quant_bits=8, channel_axis=-1):
        super().__init__(quant_bits)
        self.channel_axis = channel_axis
        self._absmax = None

    def observe(self, value):
        ndim = value.dim() if isinstance(value, torch.Tensor) \
            else np.ndim(value)
        axes = tuple(i for i in range(ndim)
                     if i != (self.channel_axis % ndim))
        cur = np.asarray(_absmax(value, axes), np.float32)
        self._absmax = (
            cur if self._absmax is None else np.maximum(self._absmax, cur)
        )

    def scales(self):
        return np.maximum(self._absmax, 1e-8) / self._qmax


def AbsmaxObserver(quant_bits=8):
    return _ObserverFactory(_AbsmaxObserver, quant_bits=quant_bits)


def PerChannelAbsmaxObserver(quant_bits=8, channel_axis=-1):
    return _ObserverFactory(
        _PerChannelAbsmaxObserver, quant_bits=quant_bits,
        channel_axis=channel_axis,
    )
