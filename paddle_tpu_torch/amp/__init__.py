"""Automatic mixed precision (counterpart of ``paddle_tpu/amp``): the O1
casts, ``decorate`` (O2), the loss scaler, ``fp8`` (O3: fp8 products
with delayed scaling), and ``debugging`` with the NaN/Inf sweep it
builds on (``naninf``)."""
from . import debugging, naninf  # noqa: F401
from . import fp8  # noqa: F401
from .auto_cast import (  # noqa: F401
    BLACK_LIST,
    WHITE_LIST,
    amp_cast,
    amp_guard,
    auto_cast,
    decorate,
    get_amp_dtype,
    is_auto_cast_enabled,
    white_list,
)
from .grad_scaler import AmpScaler, GradScaler  # noqa: F401
