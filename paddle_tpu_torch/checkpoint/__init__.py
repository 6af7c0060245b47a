"""The fault-tolerant checkpoint runtime (counterpart of
``paddle_tpu/checkpoint``):

- :mod:`snapshot`: the state copied into pinned host memory on a side
  stream; the trainer's next in-place update waits for the copies;
- :mod:`async_saver`: one background writer, at most one save in
  flight, backpressure (reported as blocked time) when a second save
  triggers early;
- :mod:`commit`: shards and their CRC32s stream into ``step_N.tmp``, a
  manifest is written last, and one rename publishes the checkpoint;
- :mod:`manager`: :class:`CheckpointManager` owns the save policy,
  last-K/every-M retention, orphan GC, verified restore with fallback,
  SIGTERM emergency saves and its metrics.

The serializer is ``paddle_tpu_torch.distributed.checkpoint``.
"""
from .async_saver import AsyncSaver  # noqa: F401
from .commit import (  # noqa: F401
    LATEST_FILE,
    MANIFEST_FILE,
    gc_orphans,
    latest_committed,
    list_committed,
    read_manifest,
    verify_checkpoint,
)
from .manager import (  # noqa: F401
    CheckpointManager,
    CheckpointPolicy,
    RestoreResult,
)
from .snapshot import (  # noqa: F401
    Snapshot,
    snapshot_is_ready,
    snapshot_nbytes,
    snapshot_state,
)

__all__ = [
    "CheckpointManager", "CheckpointPolicy", "RestoreResult",
    "AsyncSaver", "Snapshot",
    "snapshot_state", "snapshot_is_ready", "snapshot_nbytes",
    "latest_committed", "list_committed", "verify_checkpoint",
    "read_manifest", "gc_orphans", "MANIFEST_FILE", "LATEST_FILE",
]
