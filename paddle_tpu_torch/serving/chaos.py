"""Serving-side alias of the shared chaos harness (counterpart of
``paddle_tpu/serving/chaos.py``).

The one implementation lives in :mod:`paddle_tpu_torch.chaos`; this
module re-exports it verbatim (the same function objects and the same
module-level monkey slot), so ``serving.chaos.install(...)`` and
``paddle_tpu_torch.chaos.poke(...)`` always see one armed plan: the KV
wire's ``kv.send_frame`` / ``kv.recv_frame`` seams and the training
seams fire against the same monkey.
"""
from __future__ import annotations

from ..chaos import (  # noqa: F401
    ChaosClock,
    ChaosError,
    ChaosMonkey,
    active,
    chaos,
    install,
    poke,
    poke_value,
    slow_serializer,
    tear_checkpoint,
    uninstall,
    wedged_serializer,
)

__all__ = [
    "ChaosClock", "ChaosError", "ChaosMonkey", "active", "chaos",
    "install", "poke", "poke_value", "slow_serializer",
    "tear_checkpoint", "uninstall", "wedged_serializer",
]
