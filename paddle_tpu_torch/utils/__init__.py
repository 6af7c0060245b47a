"""Runtime utilities (counterpart of ``paddle_tpu/utils``): the flags
registry."""
from .flags import get_flags, set_flags  # noqa: F401
