"""PTQ: insert observers, run calibration batches, freeze the scales on
convert (counterpart of ``paddle_tpu/quantization/ptq.py``)."""
from __future__ import annotations

import copy

from torch import nn

from .qat import (
    ObservedLayer,
    _is_quant_layer,
    _resolve_then_copy,
    _swap_layers,
)


class _ObservingWrapper(nn.Module):
    def __init__(self, inner, act_observer=None, weight_observer=None):
        super().__init__()
        self._inner = inner
        self._act_observer = (
            act_observer._instance() if act_observer is not None else None
        )
        self._weight_observer = (
            weight_observer._instance() if weight_observer is not None
            else None
        )

    def forward(self, x, *args, **kw):
        if self._act_observer is not None:
            self._act_observer.observe(x)
        if self._weight_observer is not None and hasattr(
            self._inner, "weight"
        ):
            self._weight_observer.observe(self._inner.weight)
        return self._inner(x, *args, **kw)


class PTQ:
    def __init__(self, config):
        self._config = config

    def quantize(self, model, inplace=False):
        """Insert observers; run calibration data through the returned
        model, then ``convert``."""
        model, by_id = _resolve_then_copy(model, self._config, inplace)

        def make(layer):
            cfg = by_id.get(id(layer))
            if cfg is None or _is_quant_layer(layer):
                return None
            return _ObservingWrapper(
                layer, cfg.get("activation"), cfg.get("weight")
            )

        return _swap_layers(model, make)

    def convert(self, model, inplace=False):
        if not inplace:
            model = copy.deepcopy(model)

        def make(layer):
            if not isinstance(layer, _ObservingWrapper):
                return None
            act_scale = None
            act_bits = 8
            if layer._act_observer is not None:
                act_scale = layer._act_observer.scales()
                act_bits = layer._act_observer.quant_bits
            w_scale = None
            w_bits = 8
            if layer._weight_observer is not None and hasattr(
                layer._inner, "weight"
            ):
                layer._weight_observer.observe(layer._inner.weight)
                w_scale = layer._weight_observer.scales()
                w_bits = layer._weight_observer.quant_bits
            return ObservedLayer(
                layer._inner, act_scale, w_scale, act_bits, w_bits
            )

        return _swap_layers(model, make)
