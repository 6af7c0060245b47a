"""paddle_tpu_torch.training — the resilient training runtime (the port
of ``paddle_tpu/training``).

The training-side twin of the serving tier's zero-downtime ops: an
anomaly sentinel with a skip/rollback/abort policy ladder, a
hang/straggler watchdog, and the loop helper that makes
rollback-and-replay bit-identical to an uninterrupted run. They attach to
``jit.CompiledTrainStep``. See :mod:`paddle_tpu_torch.training.resilience`.
"""
from __future__ import annotations

from .resilience import (
    Action,
    AnomalySentinel,
    RollbackAndReplay,
    SentinelPolicy,
    TrainingAborted,
    TrainWatchdog,
    run_resilient,
)

__all__ = [
    "Action", "AnomalySentinel", "RollbackAndReplay", "SentinelPolicy",
    "TrainingAborted", "TrainWatchdog", "run_resilient",
]
