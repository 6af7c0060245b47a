"""Automatic mixed precision (counterpart of ``paddle_tpu/amp``)."""
from .auto_cast import (  # noqa: F401
    BLACK_LIST,
    WHITE_LIST,
    amp_cast,
    auto_cast,
    get_amp_dtype,
    is_auto_cast_enabled,
)
from .grad_scaler import AmpScaler, GradScaler  # noqa: F401
