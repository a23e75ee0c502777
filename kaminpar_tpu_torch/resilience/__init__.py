"""Graceful degradation, fault injection, checkpoints and deadlines, the
memory governor, the integrity sentinels and the strict-balance gate (own
copy of kaminpar_tpu/resilience/, less the serving supervisor and the
distributed agreement):

  * the **degradation contract**: structured exceptions (errors.py) and
    :func:`with_fallback` with its per-site circuit breaker (policy.py);
  * the **fault-injection harness**: ``KAMINPAR_TPU_FAULTS`` site plans
    (faults.py), deterministic by seed;
  * **checkpoint/resume** at the pipeline barriers (checkpoint.py) and
    the **deadline budget / anytime contract** (deadline.py);
  * the **memory governor** and its recovery ladder (memory.py);
  * the **integrity sentinels** and the retry ladder (integrity.py);
  * the **strict-balance output gate** (gate.py).
"""

from .errors import (  # noqa: F401
    AdmissionRejected,
    CacheDegraded,
    CheckpointCorrupt,
    CheckpointMismatch,
    CheckpointWriteFailed,
    CollectiveTimeout,
    DegradationError,
    DeltaApplyFailed,
    DeviceOOM,
    IntegrityViolation,
    NativeUnavailable,
    PlanBlowup,
    RankDivergence,
    RefinerRefused,
    StageHang,
    WorkerCrash,
    classify,
)
from .faults import (  # noqa: F401
    ENV_VAR as FAULTS_ENV_VAR,
    FaultPlanError,
    SITES,
    injected_log,
    maybe_inject,
    parse_plan,
    plan_summary,
    site_spec,
)
from .policy import (  # noqa: F401
    BREAKER_THRESHOLD,
    breaker_state,
    reset_breakers,
    with_fallback,
)
from . import gate  # noqa: F401
from . import integrity  # noqa: F401
from . import checkpoint  # noqa: F401
from . import deadline  # noqa: F401
from . import memory  # noqa: F401


def reset() -> None:
    """Reset injection counters, circuit breakers, integrity counters, the
    active checkpoint manager and any armed deadline (test isolation)."""
    from . import faults as _faults

    _faults.reset()
    reset_breakers()
    integrity.reset()
    checkpoint.deactivate()
    deadline.clear()
