"""Weight-decay regularizers (counterpart of ``paddle_tpu/regularizer.py``).

A parameter's ``regularizer`` attribute, its group's ``weight_decay`` or
the optimizer's ``weight_decay`` may hold one (``Optimizer._decay_value``):
``L2Decay(c)`` adds ``c * p`` to the gradient (AdamW: decays ``p`` by ``1 -
lr * c``), ``L1Decay(c)`` adds ``c * sign(p)`` (the update kernels'
prologue, ``kernels/fused_adam.py``).
"""
from __future__ import annotations


class WeightDecayRegularizer:
    pass


class L1Decay(WeightDecayRegularizer):
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def __repr__(self):
        return f"L1Decay({self.coeff})"


class L2Decay(WeightDecayRegularizer):
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def __repr__(self):
        return f"L2Decay({self.coeff})"
