"""The train step (counterpart of ``paddle_tpu/jit``)."""
from .trainer import CompiledTrainStep  # noqa: F401
