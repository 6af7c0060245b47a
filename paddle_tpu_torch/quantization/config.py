"""``QuantConfig``: which layers get quantized and with what observers
(counterpart of ``paddle_tpu/quantization/config.py``).

A layer's config is, in order: its own (:meth:`add_layer_config`, by
identity), the first type config it is an instance of
(:meth:`add_type_config`), or the global one given at construction (when
it has an activation or a weight observer); else it is not quantized.
Note that a global config applies to every layer the walk meets, the
containers first, as in JAX: a model is usually configured by type
(``add_type_config(nn.Linear, ...)``).
"""
from __future__ import annotations


class QuantConfig:
    def __init__(self, activation=None, weight=None):
        self._global_activation = activation
        self._global_weight = weight
        self._type_configs = {}
        self._layer_configs = {}

    def add_type_config(self, layer_types, activation=None, weight=None):
        if not isinstance(layer_types, (list, tuple)):
            layer_types = [layer_types]
        for t in layer_types:
            self._type_configs[t] = {
                "activation": activation, "weight": weight,
            }

    def add_layer_config(self, layers, activation=None, weight=None):
        if not isinstance(layers, (list, tuple)):
            layers = [layers]
        for layer in layers:
            self._layer_configs[id(layer)] = {
                "activation": activation, "weight": weight,
            }

    def _config_for(self, layer):
        if id(layer) in self._layer_configs:
            return self._layer_configs[id(layer)]
        for t, cfg in self._type_configs.items():
            if isinstance(layer, t):
                return cfg
        if self._global_activation or self._global_weight:
            return {
                "activation": self._global_activation,
                "weight": self._global_weight,
            }
        return None
