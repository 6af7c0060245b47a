"""Fused and multi-tensor optimizers (counterpart of
``paddle_tpu/incubate/optimizer``): ``fused_adam_update``, the multi-tensor
Adam/AdamW update (``kernels/fused_adam.py``; on the card the
``mt_adam`` kernel of ``csrc/multi_tensor.cu``), which
``optimizer.Adam(use_multi_tensor=True)`` and the train step call. The
JAX module's ``LookAhead`` and ``ModelAverage`` are not ported."""
from ...kernels.fused_adam import fused_adam_update  # noqa: F401
