"""Structured degradation exceptions (own copy of
kaminpar_tpu/resilience/errors.py, same classes and attributes).

Every optional fast path that can refuse, crash or time out raises one of
these types, and :func:`kaminpar_tpu_torch.resilience.with_fallback`
pairs each registered site with its documented fallback.  The hierarchy
is flat: callers handle :class:`DegradationError` or one subtype.
``injected=True`` marks exceptions raised by the fault-injection harness
(``KAMINPAR_TPU_FAULTS``).

:func:`classify` maps raw exceptions: a real CUDA allocator failure is
``torch.OutOfMemoryError`` (a RuntimeError whose text starts "CUDA out of
memory"), which becomes :class:`DeviceOOM` like the JAX package's
RESOURCE_EXHAUSTED.
"""

from __future__ import annotations

from typing import Optional


class DegradationError(RuntimeError):
    """Base of all structured fast-path failures.

    ``site`` is the registered fault-site name ("" until the policy
    wrapper stamps it), ``injected`` marks the fault-injection harness.
    ``breaker_relevant``: whether failures of this type advance the
    site's circuit breaker (crash-shaped failures do, deterministic
    refusals do not)."""

    breaker_relevant = True

    def __init__(
        self,
        message: str = "",
        *,
        site: Optional[str] = None,
        injected: bool = False,
    ) -> None:
        super().__init__(message or type(self).__name__)
        self.site = site or ""
        self.injected = bool(injected)


class NativeUnavailable(DegradationError):
    """A native (g++/ctypes) component could not be built, loaded or
    run.  Fallback: the numpy twin of the same entry point."""


class PlanBlowup(DegradationError):
    """A routed lane-gather plan would exceed its slot budget.  A
    refusal: does not advance the circuit breaker."""

    breaker_relevant = False


class RefinerRefused(DegradationError):
    """A refiner declined to run at the current (n, k).  Fallback: the
    partition unchanged.  A refusal: does not advance the breaker."""

    breaker_relevant = False


class CollectiveTimeout(DegradationError):
    """A cross-process collective timed out or failed.  Fallback:
    local-only data."""


class CheckpointWriteFailed(DegradationError):
    """A checkpoint snapshot or manifest could not be written.
    Fallback: in-memory-only checkpoints (durability lost, never the
    run)."""


class CheckpointCorrupt(DegradationError):
    """A snapshot failed its checksum or the manifest would not parse.
    Fallback: the previous manifest generation.  Does not advance the
    breaker."""

    breaker_relevant = False


class CheckpointMismatch(DegradationError):
    """A checkpoint belongs to another graph or context.  Policy: a clean
    restart.  Does not advance the breaker."""

    breaker_relevant = False


class AdmissionRejected(DegradationError):
    """The serving layer's admission controller refused a request.  Does
    not advance the breaker."""

    breaker_relevant = False


class CacheDegraded(DegradationError):
    """A bounded-cache lookup was forced to miss.  Does not advance the
    breaker."""

    breaker_relevant = False


class DeltaApplyFailed(DegradationError):
    """The in-place CSR delta-apply of a dynamic session failed.  Does
    not advance the breaker."""

    breaker_relevant = False


class RankDivergence(DegradationError):
    """The cross-rank divergence sentinel fired; ``ranks`` is the per-rank
    state dump."""

    def __init__(
        self,
        message: str = "",
        *,
        ranks=None,
        site: Optional[str] = None,
        injected: bool = False,
    ) -> None:
        super().__init__(message, site=site, injected=injected)
        self.ranks = list(ranks or [])


class StageHang(DegradationError):
    """A pipeline stage exceeded its hard wall-clock ceiling; ``stage``,
    ``scope_path`` and ``ceiling_s`` say where and which."""

    def __init__(
        self,
        message: str = "",
        *,
        stage: str = "",
        scope_path: str = "",
        ceiling_s: Optional[float] = None,
        site: Optional[str] = None,
        injected: bool = False,
    ) -> None:
        super().__init__(message, site=site, injected=injected)
        self.stage = stage
        self.scope_path = scope_path
        self.ceiling_s = ceiling_s


class IntegrityViolation(DegradationError):
    """An integrity sentinel or a content digest detected silent data
    corruption.  ``invariant`` names the check, ``level`` the hierarchy
    level (None outside the multilevel drivers), ``scope_path`` the
    phase boundary.  Never absorbed by ``with_fallback``: the responses
    are the bounded retry ladder (integrity.run_with_retry) or a re-fetch
    from the source."""

    def __init__(
        self,
        message: str = "",
        *,
        invariant: str = "",
        level: Optional[int] = None,
        scope_path: str = "",
        site: Optional[str] = None,
        injected: bool = False,
    ) -> None:
        super().__init__(message, site=site, injected=injected)
        self.invariant = invariant
        self.level = level
        self.scope_path = scope_path


class WorkerCrash(DegradationError):
    """A supervised worker subprocess died; ``exit_code`` is its exit
    code."""

    exit_code: Optional[int] = None


class DeviceOOM(DegradationError):
    """The card (or the host, for MemoryError) ran out of memory.
    Fallback: the path's smaller twin and, under ``compute_partition``,
    the memory governor's recovery ladder (resilience/memory.py).
    ``rungs_exhausted`` is True only when every rung failed."""

    rungs_exhausted = False


#: Raw-exception markers that classify as DeviceOOM: torch's CUDA
#: allocator ("CUDA out of memory"), XLA's RESOURCE_EXHAUSTED.
_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "Out of memory", "out of memory")


def _is_torch_oom(exc: BaseException) -> bool:
    import torch

    oom = getattr(torch, "OutOfMemoryError", None)
    return oom is not None and isinstance(exc, oom)


def classify(exc: BaseException, site: str) -> Optional[DegradationError]:
    """Map a raw exception to a structured degradation, or None.

    DegradationError passes through (site stamped if missing);
    MemoryError, ``torch.OutOfMemoryError`` and OOM-shaped messages
    become :class:`DeviceOOM`; anything else returns None and the caller
    must re-raise it."""
    if isinstance(exc, DegradationError):
        if not exc.site:
            exc.site = site
        return exc
    if isinstance(exc, MemoryError):
        err = DeviceOOM(f"host allocation failed: {exc}", site=site)
        err.__cause__ = exc
        return err
    text = f"{type(exc).__name__}: {exc}"
    if _is_torch_oom(exc) or any(m in text for m in _OOM_MARKERS):
        err = DeviceOOM(text, site=site)
        err.__cause__ = exc
        return err
    return None
