"""paddle_tpu_torch.serving.fleet — the cluster serving tier (counterpart
of ``paddle_tpu/serving/fleet``).

The unit of scaling above one engine: a fleet of engine replicas behind
an occupancy-aware router, with cross-process prefill -> decode
disaggregation.

- :mod:`router` — :class:`FleetRouter`: a stdlib HTTP front end that
  terminates ``/v1/generate`` SSE and places each request on the
  least-loaded healthy replica (free pages against queue depth, scraped
  from the replicas' ``/healthz``), with a cache-affinity bonus (keyed by
  ``session_id``, else the prompt-prefix head), per-replica circuit
  breaking, bounded retry of UNSTARTED requests, shed-with-reason when
  the fleet is saturated, drain and rolling-reload admin, and an
  aggregated ``/metrics``.
- :mod:`kv_transfer` — the disaggregation wire: a :class:`PrefillWorker`
  runs the bucketed prefill program and ships the finished KV pages as
  length-prefixed, CRC-checked frames (byte for byte the JAX package's);
  a :class:`RemotePrefillClient` attached to a ``PagedServingEngine``
  adopts them through the engine's adopt program, and any transfer
  failure falls back to a local prefill. The page-frame codec also
  serves the KV spill tier.
- :mod:`launch` — ``python -m paddle_tpu_torch.serving.fleet.launch
  --role replica|prefill|router``, and the spawn helpers.
"""
from .kv_transfer import (  # noqa: F401
    MAGIC,
    MAGIC_V1,
    MAX_FRAME_BYTES,
    PrefillWorker,
    RemotePrefillClient,
    TransferError,
)
from .router import FleetRouter, RouterMetrics  # noqa: F401
