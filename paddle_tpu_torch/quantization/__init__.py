"""Quantization (counterpart of ``paddle_tpu/quantization``):
``QuantConfig`` with QAT and PTQ over fake quantization (scales learned
or observed, the quantize-dequantize round trips in the graph with a
straight-through estimator; ``convert`` freezes the scales into
``ObservedLayer``s), and real int8 serving: weight-only int8 Linears
(:func:`quantize_for_serving`, :class:`QuantizedLinear`, run by the
W8A16 kernel; an ``ObservedLayer`` keeps its calibrated per-channel
scales) and the int8 KV cache (:mod:`.kv`, ``QuantizedKV``)."""
from .config import QuantConfig  # noqa: F401
from .observers import (  # noqa: F401
    AbsmaxObserver,
    PerChannelAbsmaxObserver,
)
from .qat import QAT  # noqa: F401
from .ptq import PTQ  # noqa: F401
from .quanters import FakeQuanterWithAbsMaxObserver  # noqa: F401
from .serving import (  # noqa: F401
    QuantizedLinear,
    quantize_for_serving,
)
from . import kv  # noqa: F401
