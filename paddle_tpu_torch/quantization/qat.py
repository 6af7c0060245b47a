"""QAT: wrap the configured layers so that their forward fake-quantizes
the input activation and the weight; training gradients flow through
the straight-through estimator (counterpart of
``paddle_tpu/quantization/qat.py``).

The walk goes over ``nn.Module._modules`` where JAX's goes over
``_sub_layers``, in the same order, and never descends into a layer it
wrapped or a quantized one. A wrapped layer's weight is swapped for its
fake-quantized value only for the wrapped forward (an instance attribute
that shadows the parameter, removed after).
"""
from __future__ import annotations

import contextlib
import copy

from torch import nn

from .quanters import fake_quant


@contextlib.contextmanager
def _weight_as(layer, value):
    """``layer.weight`` reads ``value`` inside the block; the parameter is
    untouched."""
    layer.__dict__["weight"] = value
    try:
        yield
    finally:
        del layer.__dict__["weight"]


class QuantedWrapper(nn.Module):
    """Wraps one layer: fake-quant of the input activation and of the
    weight, then the wrapped layer with the quantized weight."""

    def __init__(self, inner, act_quanter=None, weight_quanter=None):
        super().__init__()
        self._inner = inner
        self._act_quanter = (
            act_quanter._instance() if act_quanter is not None else None
        )
        self._weight_quanter = (
            weight_quanter._instance() if weight_quanter is not None
            else None
        )

    def forward(self, x, *args, **kw):
        if self._act_quanter is not None:
            x = self._act_quanter(x)
        wq = self._weight_quanter
        if wq is not None and hasattr(self._inner, "weight"):
            w = self._inner.weight
            if hasattr(wq, "observe"):  # an observer (per-channel etc.)
                wq.observe(w)
                wfq = fake_quant(w, wq.scales(), wq.quant_bits)
            else:  # a quanter (the moving-average fake quanter)
                wfq = wq(w)
            with _weight_as(self._inner, wfq):
                return self._inner(x, *args, **kw)
        return self._inner(x, *args, **kw)


class ObservedLayer(nn.Module):
    """The layer after convert: quant arithmetic with frozen scales.
    Activation and weight bit widths are kept apart (they may differ by
    config)."""

    def __init__(self, inner, act_scale, weight_scale, act_bits=8,
                 weight_bits=8):
        super().__init__()
        self._inner = inner
        self.act_scale = act_scale
        self.weight_scale = weight_scale
        self.act_bits = act_bits
        self.weight_bits = weight_bits

    def forward(self, x, *args, **kw):
        if self.act_scale is not None:
            x = fake_quant(x, self.act_scale, self.act_bits)
        if self.weight_scale is not None and hasattr(self._inner, "weight"):
            wfq = fake_quant(self._inner.weight, self.weight_scale,
                             self.weight_bits)
            with _weight_as(self._inner, wfq):
                return self._inner(x, *args, **kw)
        return self._inner(x, *args, **kw)


# layers the walker never descends into (their _inner would be matched
# and wrapped twice). QuantizedLinear (serving.py) and the PTQ wrapper
# match by name, as in JAX: wrapping an int8 layer in a fake quant (or
# quantizing it again) would round its weights twice.
def _is_quant_layer(layer):
    return isinstance(layer, (QuantedWrapper, ObservedLayer)) or (
        type(layer).__name__ in ("_ObservingWrapper", "QuantizedLinear")
    )


def _swap_layers(model, make):
    """Replace the matching submodules in place (walking named children);
    no descent into quantized wrappers."""
    for name, child in list(model._modules.items()):
        if child is None:
            continue
        replacement = make(child)
        if replacement is not None:
            model._modules[name] = replacement
        elif not _is_quant_layer(child):
            _swap_layers(child, make)
    return model


def _named_paths(model, prefix=""):
    for name, child in model._modules.items():
        if child is None:
            continue
        path = f"{prefix}.{name}" if prefix else name
        yield path, child
        if not _is_quant_layer(child):
            yield from _named_paths(child, path)


def _layer_by_path(model, path):
    cur = model
    for part in path.split("."):
        cur = cur._modules[part]
    return cur


def _resolve_then_copy(model, config, inplace):
    """Resolve each layer's config on the original model (so
    ``add_layer_config``'s identities survive the copy), then copy."""
    resolved = {
        path: config._config_for(layer)
        for path, layer in _named_paths(model)
    }
    if not inplace:
        model = copy.deepcopy(model)
    by_id = {
        id(_layer_by_path(model, path)): cfg
        for path, cfg in resolved.items()
    }
    return model, by_id


class QAT:
    def __init__(self, config):
        self._config = config

    def quantize(self, model, inplace=False):
        model, by_id = _resolve_then_copy(model, self._config, inplace)

        def make(layer):
            cfg = by_id.get(id(layer))
            if cfg is None or _is_quant_layer(layer):
                return None
            return QuantedWrapper(
                layer, cfg.get("activation"), cfg.get("weight")
            )

        return _swap_layers(model, make)

    def convert(self, model, inplace=False):
        """Freeze the learned scales into ObservedLayers."""
        if not inplace:
            model = copy.deepcopy(model)

        def make(layer):
            if not isinstance(layer, QuantedWrapper):
                return None
            aq = layer._act_quanter
            act_scale = None
            act_bits = 8
            if aq is not None:
                act_scale = (
                    aq.scales() if hasattr(aq, "observe") else aq.scale()
                )
                act_bits = aq.quant_bits
            w_scale = None
            w_bits = 8
            wq = layer._weight_quanter
            if wq is not None and hasattr(layer._inner, "weight"):
                if hasattr(wq, "observe"):
                    wq.observe(layer._inner.weight)
                    w_scale = wq.scales()
                elif wq._initialized:
                    # freeze the trained moving-average scale; no more
                    # moving-average updates here
                    w_scale = wq.scale()
                else:
                    w = layer._inner.weight.detach()
                    wq._state = (float(w.abs().amax()) if w.numel()
                                 else 0.0)
                    wq._initialized = True
                    w_scale = wq.scale()
                w_bits = wq.quant_bits
            return ObservedLayer(
                layer._inner, act_scale, w_scale, act_bits, w_bits
            )

        return _swap_layers(model, make)
