"""Continuous-batching serving for the port (counterpart of
``paddle_tpu/serving``): the slab engine, the paged engine with its
prefix cache, speculative decoding for both, and the host-side pieces
they share."""
from .engine import ServingEngine  # noqa: F401
from .kv_pool import KVBlock, KVCachePool, bucket_for  # noqa: F401
from .metrics import ServingMetrics  # noqa: F401
from .paged_engine import PagedServingEngine  # noqa: F401
from .paged_pool import PagedKVPool, PagesExhausted  # noqa: F401
from .prefix_cache import PrefixCache, PrefixEntry, PrefixMatch  # noqa
from .sampling_keys import (  # noqa: F401
    ACCEPT,
    DRAFT,
    RESIDUAL,
    SamplingKeySource,
    position_key,
    purpose_key,
)
from .scheduler import (  # noqa: F401
    CANCELLED,
    DONE,
    QUEUED,
    REASON_ENGINE_CLOSED,
    REASON_PAGES_EXHAUSTED,
    REASON_QUEUE_FULL,
    REASON_SHAPE_MISMATCH,
    REASON_TIMEOUT,
    REASON_TOO_LONG,
    REJECTED,
    RUNNING,
    TIMEOUT,
    RejectedError,
    Request,
    RequestHandle,
    Scheduler,
)
from .speculative import SpeculativeDecoder  # noqa: F401
