"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

This package stands beside ``paddle_tpu`` (the JAX reference, which it
never imports) and mirrors its module paths. It serves and trains the
Llama family: the model (``models.llama``), KV-cache generation
(``models.generation``), the slab and paged continuous-batching engines
(``serving``), quantized serving (int8 KV caches and int8 weights,
``quantization``), and the train step (``jit.CompiledTrainStep`` with
``optimizer`` and ``amp``), with hand-written Hopper kernels for RMSNorm
and rope (forward and backward), paged decode attention (float and int8
arenas), flash attention (forward and backward) and the W8A16 matmul
(``kernels``, sources in ``csrc/``).

Entry points run on the first CUDA card unless the caller passes
``device="cpu"``; without a card and without a device they raise.
"""
from .device import default_device, resolve_device  # noqa: F401
from .models import LlamaConfig, LlamaForCausalLM, generate  # noqa: F401
from .serving import PagedServingEngine, ServingEngine  # noqa: F401

__version__ = "0.1.0"
