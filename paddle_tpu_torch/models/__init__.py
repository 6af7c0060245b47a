"""Models of the port (counterpart of ``paddle_tpu/models``)."""
from .generation import generate  # noqa: F401
from .llama import (  # noqa: F401
    LlamaAttention,
    LlamaConfig,
    LlamaDecoderLayer,
    LlamaForCausalLM,
    LlamaMLP,
    LlamaModel,
    causal_lm_loss,
)
