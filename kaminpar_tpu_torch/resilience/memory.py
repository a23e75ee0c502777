"""Device-memory estimators and the declared budget (counterpart of the
estimator half of kaminpar_tpu/resilience/memory.py, same formulas).

This package has no memory governor: no admission, no OOM recovery
ladder and no spilled hierarchy.  A declared budget
(``ctx.resilience.memory_budget``, else ``KAMINPAR_TPU_HBM_BYTES``) acts
only on the external scheme (external/driver.py): it shrinks the stream's
chunk target until the stream state fits, and keeps streaming levels
until the coarse level's run estimate fits
``STREAM_TARGET_FRACTION`` of it.
"""

from __future__ import annotations

import os
from typing import Any, Optional, Tuple

from ..caching import pad_k, pad_size
from ..graphs.csr import shape_floors

#: The declared device-memory budget in bytes (when the context has none).
ENV_BUDGET = "KAMINPAR_TPU_HBM_BYTES"
#: The streamed coarsening target: the coarse graph's estimate must fit
#: this fraction of the budget before the in-core pipeline takes over.
STREAM_TARGET_FRACTION = 0.8

#: Resident hierarchy factor over the finest level's CSR.
HIERARCHY_FACTOR = 1.5
#: n_pad-shaped int32 working arrays live across launches.
NODE_WORK_ARRAYS = 2
#: m_pad-shaped int32 working arrays held across launches.
EDGE_WORK_ARRAYS = 1
#: k_pad-shaped tables (block weights, caps, per-block gains), int64.
K_TABLE_ARRAYS = 8
#: Bytes of one device weight (int32).
WEIGHT_BYTES = 4


def padded_bucket(n: int, m: int, k: int) -> Tuple[int, int, int]:
    """The padded shapes ``(n_pad, m_pad, k_pad)`` a run over (n, m, k)
    occupies — the unit the estimator prices."""
    n_floor, m_floor = shape_floors()
    return (pad_size(int(n) + 1, n_floor), pad_size(max(int(m), 1), m_floor),
            pad_k(max(int(k), 1)))


def device_csr_bytes(n_pad: int, m_pad: int) -> int:
    """Bytes of one padded device CSR + COO level (row_ptr, src, dst,
    edge_w, node_w)."""
    w = WEIGHT_BYTES
    return 4 * (n_pad + 1) + n_pad * (4 + w) + m_pad * (8 + w)


def estimate_run_bytes(n: int, m: int, k: int, ctx: Any = None) -> int:
    """Estimated peak device bytes of an in-core run over the padded
    shapes of (n, m, k): the resident hierarchy plus the working arrays.
    ``ctx`` is accepted for signature parity."""
    del ctx
    n_pad, m_pad, k_pad = padded_bucket(n, m, k)
    transient = (
        NODE_WORK_ARRAYS * n_pad * 4
        + EDGE_WORK_ARRAYS * m_pad * 4
        + K_TABLE_ARRAYS * k_pad * 8
    )
    return int(HIERARCHY_FACTOR * device_csr_bytes(n_pad, m_pad) + transient)


def estimate_stream_bytes(n: int, chunk_edges: int, k: int) -> int:
    """Peak device bytes of the external scheme's stream phase: two
    in-flight padded chunk buffers (src_local, dst, weights), the fine
    level's O(n) vectors (labels, wanted, cluster weights, node weights,
    cluster map) and the k tables."""
    w = WEIGHT_BYTES
    e_pad = pad_size(max(int(chunk_edges), 1), 4096)
    chunk = e_pad * (4 + 4 + w)
    vectors = int(n) * (4 + 4 + 4 + 2 * w)
    k_pad = pad_k(max(int(k), 1))
    return int(2 * chunk + vectors + K_TABLE_ARRAYS * k_pad * 8)


def min_streamable_bytes(n: int, k: int) -> int:
    """The smallest budget the external scheme can stream a graph under
    (the floor chunk target of 2^15 edges)."""
    return estimate_stream_bytes(n, 1 << 15, k)


def budget_bytes(ctx: Any = None) -> Optional[int]:
    """The declared device-memory budget: ``ctx.resilience.memory_budget``
    when positive, else ``KAMINPAR_TPU_HBM_BYTES``; None when neither is
    declared."""
    if ctx is not None:
        res = getattr(ctx, "resilience", None)
        declared = float(getattr(res, "memory_budget", 0.0) or 0.0)
        if declared > 0:
            return int(declared)
    raw = os.environ.get(ENV_BUDGET, "")
    if raw:
        try:
            return int(float(raw))
        except ValueError:
            return None
    return None
