"""Partitioning as a service (own copy of kaminpar_tpu/serving/): an
admission-controlled request queue with per-request fault isolation and
bounded caches, for a process that serves many graphs.

  * :class:`~.service.PartitionService` (``device=``, the card by
    default): a bounded queue with admission control (queue-depth and
    estimated-cost caps; overload gives a structured ``rejected``
    verdict), per-request fault isolation (a malformed graph or a
    ``DeviceOOM`` fails that request while the service keeps serving),
    optional process isolation in a supervised worker
    (resilience/supervisor.py), a per-request-class circuit breaker,
    per-request anytime deadlines, SIGTERM draining, and the session
    request kinds ``register``, ``mutate`` and ``repartition`` over
    ``dynamic/``;
  * a result cache (:class:`..caching.BoundedCache`) keyed by (graph
    identity, context fingerprint), with an entry cap and a byte budget,
    plus shape-bucket reuse accounting (:class:`..caching.BucketTracker`);
  * the run report's ``serving`` section: every request's verdict
    (``served`` / ``anytime`` / ``degraded`` / ``rejected`` / ``failed``)
    with admission, cache and latency statistics.

Command line: ``python -m kaminpar_tpu_torch --serve-batch BATCH.json``
(serving/batch.py).
"""

from .service import (  # noqa: F401
    PartitionRequest,
    PartitionService,
    RequestRecord,
    ServiceConfig,
    VERDICTS,
)
