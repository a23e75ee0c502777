"""The degradation contract: ``with_fallback`` and the per-site circuit
breaker (own copy of kaminpar_tpu/resilience/policy.py).

A site failure is a structured exception (errors.classify); an
unclassified exception propagates unchanged.  Every engaged fallback
emits a ``degraded`` telemetry event naming the site, the error and the
fallback.  After BREAKER_THRESHOLD consecutive fallback engagements the
site's breaker opens and the primary is not tried again in this
process.  An IntegrityViolation is never absorbed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, TypeVar

from . import faults
from .errors import DegradationError, classify

T = TypeVar("T")

#: Consecutive fallback engagements before a site's breaker opens.
BREAKER_THRESHOLD = 3


@dataclass
class _Breaker:
    consecutive_failures: int = 0
    open: bool = False
    last_error: str = ""


_breakers: Dict[str, _Breaker] = {}


def breaker_state(site: str) -> dict:
    """The site's breaker as a dict (tests, run-report debugging)."""
    br = _breakers.get(site, _Breaker())
    return {
        "open": br.open,
        "consecutive_failures": br.consecutive_failures,
        "last_error": br.last_error,
    }


def reset_breakers() -> None:
    """Close every breaker (test isolation; also sensible between
    independent CLI invocations in one process)."""
    _breakers.clear()


def _emit_degraded(site: str, spec, *, error: str, detail: str,
                   attempts: int, breaker_open: bool, injected: bool,
                   recovered: bool = False, where: str = "") -> None:
    from .. import telemetry
    from ..utils.logger import log_warning

    telemetry.event(
        "degraded",
        site=site,
        error=error,
        detail=detail[:300],
        fallback="retry(primary)" if recovered else spec.fallback,
        attempts=attempts,
        breaker_open=breaker_open,
        injected=injected,
        recovered=recovered,
        where=where or None,
    )
    what = "recovered by retry" if recovered else f"falling back to {spec.fallback}"
    log_warning(
        f"degraded[{site}{'@' + where if where else ''}]: {error} "
        f"({detail[:120]}); {what}"
        + (" [circuit breaker OPEN]" if breaker_open else "")
    )


def with_fallback(
    primary: Callable[[], T],
    fallback: Optional[Callable[[Optional[DegradationError]], T]],
    site: str,
    retries: int = 0,
    where: str = "",
) -> T:
    """Run ``primary()`` under the site's degradation contract.

    * ``site`` must be registered in faults.SITES (KeyError otherwise).
    * Fault injection fires at the site entry (attempt 0 only — an
      injected fault models a deterministic failure and goes straight to
      the fallback; retries exercise real transient failures).
    * On a classified failure, ``primary`` is retried up to ``retries``
      times; recovery by retry emits a ``degraded`` event with
      ``recovered=True`` (the degradation is visible either way).
    * When all attempts fail: the breaker is advanced, a ``degraded``
      event is emitted, and ``fallback(exc)`` is returned.  With
      ``fallback=None`` the structured exception propagates to the
      caller instead (still never silent).
    * With the breaker open the primary is skipped entirely and
      ``fallback(None)`` is returned immediately.
    * ``where`` labels the call site (e.g. the driver phase) in the
      event, so one site wired through several drivers stays tellable.

    Unclassified exceptions (not a DegradationError, not OOM-shaped)
    propagate unchanged.
    """
    spec = faults.site_spec(site)
    br = _breakers.setdefault(site, _Breaker())
    if br.open:
        _emit_degraded(
            site, spec, error="circuit-open",
            detail=f"breaker open after {br.consecutive_failures} "
                   f"consecutive failures (last: {br.last_error})",
            attempts=0, breaker_open=True, injected=False, where=where,
        )
        if fallback is None:
            raise spec.exc(
                f"site '{site}' circuit breaker is open "
                f"(last error: {br.last_error})", site=site,
            )
        return fallback(None)

    last: Optional[DegradationError] = None
    for attempt in range(max(0, retries) + 1):
        try:
            if attempt == 0:
                faults.maybe_inject(site)
            result = primary()
        except Exception as exc:  # classified below; unknowns re-raise
            from .errors import IntegrityViolation, StageHang

            if isinstance(exc, IntegrityViolation):
                # detected silent data corruption has no documented
                # fallback twin — absorbing it would serve a wrong
                # answer under a `degraded` verdict.  It propagates to
                # the retry-from-last-good-barrier ladder
                # (integrity.run_with_retry) or the caller's explicit
                # re-fetch path, never into this site's fallback.
                raise
            if isinstance(exc, StageHang) and not exc.injected:
                # an async-delivered watchdog verdict (a hung stage)
                # is a process-level failure that happened to LAND
                # inside this site's primary — it must propagate to
                # the hang-containment boundary, never be absorbed as
                # this site's degradation
                raise
            err = classify(exc, site)
            if err is None:
                raise
            last = err
            continue
        br.consecutive_failures = 0
        if attempt and last is not None:
            _emit_degraded(
                site, spec, error=type(last).__name__, detail=str(last),
                attempts=attempt + 1, breaker_open=False,
                injected=last.injected, recovered=True, where=where,
            )
        return result

    assert last is not None
    if last.breaker_relevant:
        # injected faults advance the breaker too: the chaos suite
        # asserts breaker behavior with the same machinery as real
        # failures.  Refusal-shaped errors (breaker_relevant=False —
        # plan blowups, FM refusals) engage the fallback without
        # latching: the next input may be perfectly servable.
        br.consecutive_failures += 1
        br.last_error = f"{type(last).__name__}: {last}"
        br.open = br.consecutive_failures >= BREAKER_THRESHOLD
    _emit_degraded(
        site, spec, error=type(last).__name__, detail=str(last),
        attempts=max(0, retries) + 1, breaker_open=br.open,
        injected=last.injected, where=where,
    )
    if fallback is None:
        raise last
    return fallback(last)
