"""The layers the Llama path builds on, with Paddle's parameter names
and layouts (counterparts of ``paddle_tpu/nn/layer/common.py`` Linear
and Embedding, and ``nn/layer/norm.py`` RMSNorm).

Parameters are created on the caller's device and dtype and filled by
``reset_parameters(generator)`` with Paddle's default initializers
(Xavier-uniform Linear weights, standard-normal embeddings, unit norm
weights), drawn from an explicit ``torch.Generator`` on that device.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from . import functional as F


def _param(shape, device, dtype):
    # trainable; the serving paths run under torch.inference_mode()
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype))


class Linear(nn.Module):
    """``y = x @ W`` with Paddle's ``[in_features, out_features]``
    weight, so state dicts cross between the packages unchanged (the
    Llama path's projections carry no bias)."""

    def __init__(self, in_features, out_features, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.in_features = int(in_features)
        self.out_features = int(out_features)
        self.weight = _param((in_features, out_features), device, dtype)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        bound = math.sqrt(6.0 / (self.in_features + self.out_features))
        self.weight.uniform_(-bound, bound, generator=generator)

    def forward(self, x):
        return F.linear(x, self.weight)


class Embedding(nn.Module):
    def __init__(self, num_embeddings, embedding_dim, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.weight = _param((num_embeddings, embedding_dim), device, dtype)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        self.weight.normal_(0.0, 1.0, generator=generator)

    def forward(self, ids):
        return torch.nn.functional.embedding(ids, self.weight)


class RMSNorm(nn.Module):
    def __init__(self, hidden_size, epsilon=1e-6, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self._epsilon = float(epsilon)
        self.weight = _param((hidden_size,), device, dtype)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        self.weight.fill_(1.0)

    def forward(self, x):
        return F.rms_norm(x, self.weight, epsilon=self._epsilon)
