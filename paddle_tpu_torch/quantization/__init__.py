"""Quantized serving storage and execution (counterpart of
``paddle_tpu/quantization``): the int8 KV cache (:mod:`.kv`,
``QuantizedKV``) and int8 weight-only Linears
(:func:`quantize_for_serving`, :class:`QuantizedLinear`). PTQ and QAT
are not ported yet."""
from . import kv  # noqa: F401
from .serving import QuantizedLinear, quantize_for_serving  # noqa: F401
