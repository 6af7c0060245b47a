"""Automatic mixed precision, the O1 casts (counterpart of
``paddle_tpu/amp/auto_cast.py``).

A thread-local state, switched by :func:`auto_cast`, that the port's
functionals read through :func:`amp_cast`, at the places where the JAX
package's dispatch hook casts (``auto_cast.py:58-78``): a white-listed
op (the matmul carriers: ``linear``, ``matmul``,
``scaled_dot_product_attention``, ``flash_attention`` ...) casts its
fp32 inputs to the low dtype; a black-listed op (``cross_entropy``,
``softmax``, ``log_softmax``, ``mean``, ``sum`` ...) casts low-dtype
inputs to fp32; every other op runs in the types it is given. So, as in
the JAX package, the residual stream stays fp32 (fp32 + bf16 promotes
to fp32), RMSNorm sees fp32, and the projections, rope and attention
run in bf16. ``torch.autocast`` is not used: its op lists differ, and
the casts must sit where the JAX package puts them.

Every level casts as O1 here, as JAX's hook does (it records the level
and never reads it). O3 adds fp8 products to O1's casts, in the train
step (``amp/fp8.py``). O2 behaves as O1 inside the train step, as in the JAX trainer
(``trainer.py:322-331``), since the casts are the same hook. What makes
O2 different is :func:`decorate` (``auto_cast.py:108-118``): it casts the
net's floating parameters and buffers to the low dtype, and the
optimizers keep their fp32 accumulators and compute each update in fp32,
casting the result back (master-weight semantics, as JAX's update rules
upcast). RMSNorm (``fused_rms_norm``, on neither list) then runs on the
low-dtype residual stream.
"""
from __future__ import annotations

import contextlib
import threading

import torch

# ops that run in low precision under O1 (auto_cast.py:29-33)
WHITE_LIST = frozenset({
    "matmul", "mm", "bmm", "linear", "conv1d", "conv2d", "conv3d",
    "conv1d_transpose", "conv2d_transpose", "conv3d_transpose", "einsum",
    "addmm", "flash_attention", "scaled_dot_product_attention",
})
# ops forced to float32 (auto_cast.py:35-41)
BLACK_LIST = frozenset({
    "softmax_with_cross_entropy", "cross_entropy", "log_softmax", "softmax",
    "layer_norm", "batch_norm_train", "batch_norm_infer", "rms_norm",
    "logsumexp", "mean", "sum", "norm", "group_norm", "nll_loss",
    "binary_cross_entropy", "bce_with_logits", "mse_loss", "l1_loss",
    "kl_div", "exp", "log", "pow", "erf",
})

white_list = WHITE_LIST  # paddle exposes these names

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}


class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False
        self.dtype = torch.bfloat16
        self.level = "O1"
        self.custom_white = frozenset()
        self.custom_black = frozenset()


_STATE = _AmpState()


def amp_cast(op_name, *tensors):
    """``tensors`` as op ``op_name`` sees them under the active state
    (None and non-tensors pass through); one value in, one value out."""
    st = _STATE
    if not st.enabled:
        return tensors[0] if len(tensors) == 1 else tensors
    low = st.dtype
    white = (op_name in WHITE_LIST or op_name in st.custom_white) \
        and op_name not in st.custom_black
    black = op_name in BLACK_LIST or op_name in st.custom_black
    out = []
    for t in tensors:
        if isinstance(t, torch.Tensor):
            if white and t.dtype == torch.float32:
                t = t.to(low)
            elif black and t.dtype == low:
                t = t.float()
        out.append(t)
    return out[0] if len(out) == 1 else tuple(out)


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16", use_promote=True):
    """Turn the O1 casts on (or off) for the calling thread. As in JAX
    (``auto_cast.py:85-105``) ``level`` is recorded and not read: any
    level with ``enable`` casts as O1 ("O0" too; "O3" is O1's casts, its
    fp8 products are the trainer's, ``amp/fp8.py``), and ``use_promote``
    is taken and unused."""
    if isinstance(dtype, str):
        if dtype not in _DTYPES:
            raise ValueError(f"auto_cast dtype must be one of "
                             f"{sorted(_DTYPES)}, got {dtype!r}")
        dtype = _DTYPES[dtype]
    st = _STATE
    prev = (st.enabled, st.dtype, st.level, st.custom_white,
            st.custom_black)
    st.enabled = bool(enable)
    st.dtype = dtype
    st.level = level
    st.custom_white = frozenset(custom_white_list or ())
    st.custom_black = frozenset(custom_black_list or ())
    try:
        yield
    finally:
        (st.enabled, st.dtype, st.level, st.custom_white,
         st.custom_black) = prev


amp_guard = auto_cast


def _as_dtype(dtype):
    if isinstance(dtype, str):
        if dtype not in _DTYPES and dtype != "float32":
            raise ValueError(f"decorate dtype must be one of "
                             f"{sorted(_DTYPES)}, got {dtype!r}")
        return _DTYPES.get(dtype, torch.float32)
    return dtype


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """O2: cast each model's floating parameters and buffers to the low
    dtype (``nn.Module.to``: in place, the same parameter objects, so an
    optimizer built on them keeps them); the optimizers' math stays fp32
    (their accumulators are fp32 and each update upcasts, as JAX's
    ``_adam_update`` does). Any other level leaves the models as they
    are. Returns the models (and the optimizers, when given) as they
    came: one or a list."""
    single_model = not isinstance(models, (list, tuple))
    model_list = [models] if single_model else list(models)
    if level == "O2":
        low = _as_dtype(dtype)
        for m in model_list:
            m.to(dtype=low)
    if optimizers is None:
        return models if single_model else model_list
    return (models if single_model else model_list), optimizers


def is_auto_cast_enabled():
    return _STATE.enabled


def get_amp_dtype():
    return _STATE.dtype
