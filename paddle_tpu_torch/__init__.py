"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

This package stands beside ``paddle_tpu`` (the JAX reference, which it
never imports) and mirrors its module paths. It serves and trains the
Llama family: the model (``models.llama``), KV-cache generation
(``models.generation``), the slab and paged continuous-batching engines
(``serving``, with live weight reload, the HTTP/SSE front end and the
fleet tier: remote prefill over the KV wire, the router, the launch
entry points), quantized serving (int8 KV
caches and int8 weights, ``quantization``), the train step
(``jit.CompiledTrainStep`` with ``optimizer`` and ``amp``: bf16 or fp16,
``decorate``, the NaN/Inf sweep of ``set_flags({"FLAGS_check_nan_inf":
True})``; the eager-only optimizers), and
checkpoints (``checkpoint``, the format in ``distributed.checkpoint``,
fault injection in ``chaos``), the resilient training runtime
(``training``: the anomaly sentinel, the watchdog, ``run_resilient``), with hand-written Hopper kernels for RMSNorm
and rope (forward and backward), paged decode attention (float and int8
arenas), flash attention (forward and backward), the W8A16 matmul, the two
fusions and the multi-tensor optimizer updates (``kernels``, sources in
``csrc/``).

Entry points run on the first CUDA card unless the caller passes
``device="cpu"``; without a card and without a device they raise.
"""
from .device import default_device, resolve_device  # noqa: F401
from .utils.flags import get_flags, set_flags  # noqa: F401
from .models import LlamaConfig, LlamaForCausalLM, generate  # noqa: F401
from .serving import PagedServingEngine, ServingEngine  # noqa: F401

__version__ = "0.1.0"
