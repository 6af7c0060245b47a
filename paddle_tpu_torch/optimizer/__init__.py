"""Optimizers, schedulers and clipping (counterpart of
``paddle_tpu/optimizer``)."""
from . import lr  # noqa: F401
from .clip import ClipGradByGlobalNorm  # noqa: F401
from .lr import CosineAnnealingDecay, LinearWarmup, LRScheduler  # noqa: F401
from .optimizer import Adam, AdamW, Optimizer  # noqa: F401
