"""Continuous-batching serving for the port (counterpart of
``paddle_tpu/serving``): the slab engine, the paged engine with its
prefix cache and the KV spill tier below it, speculative decoding for
both, sessions, live weight reload, the HTTP/SSE front end
(``ServingFrontend``), the fleet tier above it (``fleet``: the KV wire's
``PrefillWorker`` and ``RemotePrefillClient``, the ``FleetRouter``, the
launch entry points), and the host-side pieces they share.
``serving.chaos`` re-exports ``paddle_tpu_torch.chaos``, as the JAX
package's does."""
from . import chaos  # noqa: F401
from .engine import ServingEngine  # noqa: F401
from .fleet import (  # noqa: F401
    FleetRouter,
    PrefillWorker,
    RemotePrefillClient,
    RouterMetrics,
    TransferError,
)
from .http_frontend import (  # noqa: F401
    FrontendMetrics,
    HTTPRejected,
    ServingFrontend,
    read_sse_events,
    stream_generate,
)
from .kv_pool import KVBlock, KVCachePool, bucket_for  # noqa: F401
from .kv_tiering import TieredPageStore, pack_page, unpack_page  # noqa
from .metrics import ServingMetrics  # noqa: F401
from .paged_engine import PagedServingEngine  # noqa: F401
from .paged_pool import PagedKVPool, PagesExhausted  # noqa: F401
from .prefix_cache import PrefixCache, PrefixEntry, PrefixMatch  # noqa
from .reload import ReloadError, StagedReload  # noqa: F401
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
from .sessions import Session, SessionStore  # noqa: F401
from .speculative import SpeculativeDecoder  # noqa: F401
