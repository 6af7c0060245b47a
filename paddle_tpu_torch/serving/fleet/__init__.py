"""The fleet tier's host side (counterpart of ``paddle_tpu/serving/
fleet``). Only the page-frame codec of :mod:`.kv_transfer` is ported so
far, for the KV spill tier (``serving/kv_tiering.py``); the router,
the prefill worker and the launch helpers are ``ROADMAP.md`` queue A
items 1.7 and 4."""
from .kv_transfer import (  # noqa: F401
    MAGIC,
    MAGIC_V1,
    MAX_FRAME_BYTES,
    TransferError,
)
