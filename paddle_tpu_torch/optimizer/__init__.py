"""Optimizers, schedulers, clipping and regularizers (counterpart of
``paddle_tpu/optimizer`` and ``paddle_tpu/regularizer.py``)."""
from . import lr  # noqa: F401
from .clip import (  # noqa: F401
    ClipGradBase,
    ClipGradByGlobalNorm,
    ClipGradByNorm,
    ClipGradByValue,
    clip_grad_norm_,
)
from .lr import CosineAnnealingDecay, LinearWarmup, LRScheduler  # noqa: F401
from .optimizer import (  # noqa: F401
    SGD,
    Adadelta,
    Adagrad,
    Adam,
    Adamax,
    AdamW,
    Lamb,
    Momentum,
    Optimizer,
    RMSProp,
)
from .extra import ASGD, LBFGS, NAdam, RAdam, Rprop  # noqa: F401
from .regularizer import L1Decay, L2Decay  # noqa: F401
