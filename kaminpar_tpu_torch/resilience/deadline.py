"""Deadline budget and cooperative preemption, the anytime contract (own
copy of kaminpar_tpu/resilience/deadline.py).

``ctx.resilience.time_budget`` installs a monotonic deadline that the
pipeline checks at its barriers (coarsening levels, initial
partitioning, each uncoarsening level, each v-cycle) and between refiner
steps.  Nothing is interrupted mid-kernel: on expiry the drivers stop
starting optional work (further coarsening, refinement steps, cycles),
finish what validity requires (projection, extension to k, balance, the
output gate), and the facade annotates the result ``anytime: true`` with
the stage reached (``KaMinPar.last_anytime``).  SIGTERM/SIGINT, once
``install_signal_handlers`` routed them, request the same stop; a second
delivery of the signal restores its old handler.

The state lives on the per-run :class:`~.runstate.RunState`; signals are
process-wide.  The budget cannot interrupt a launch that never returns:
the hard wall-clock watchdog (resilience/supervisor.py), armed at
``hard_deadline_factor`` times the budget, is the backstop.
"""

from __future__ import annotations

import signal
import time
from typing import Optional

from . import runstate

#: Default DECLARED wind-down grace on top of the budget: the allowance
#: the mandatory tail (extension, gate/repair, final checkpoint, report)
#: is expected to fit.  Advisory — reported in the anytime section so
#: operators can size preemption windows; the cooperative tail is not
#: forcibly interrupted.  Overridable via ctx.resilience.budget_grace.
DEFAULT_GRACE_S = runstate.DEFAULT_GRACE_S

_prev_handlers: dict = {}


def install_budget(budget_s: float, grace_s: Optional[float] = None,
                   hard_factor: Optional[float] = None) -> None:
    """Arm a fresh deadline ``budget_s`` seconds from now on the calling
    thread's run.  The budget is cooperative: it is checked between
    kernel launches at the pipeline barriers.  When a hard ceiling is
    armed for it (``hard_factor``, the context's
    ``hard_deadline_factor``, or KAMINPAR_TPU_HARD_DEADLINE_S), a
    ``watchdog-armed`` event records the ceiling."""
    run = runstate.current()
    run.budget_s = float(budget_s)
    run.grace_s = float(grace_s) if grace_s is not None else DEFAULT_GRACE_S
    run.t0 = time.monotonic()
    run.deadline = run.t0 + run.budget_s
    run.stop = False
    run.reason = ""
    run.announced = False
    from . import supervisor

    ceiling = supervisor.hard_ceiling(run.budget_s, run.grace_s,
                                      hard_factor)
    if ceiling is not None:
        from .. import telemetry

        telemetry.event(
            "watchdog-armed",
            ceiling_s=round(ceiling, 3),
            budget_s=run.budget_s,
        )


def clear() -> None:
    """Disarm the deadline and any pending stop request — including a
    process-wide signal flag (test isolation between runs)."""
    runstate.begin()
    runstate.clear_signal()


def begin_run(budget_s: Optional[float] = None,
              grace_s: Optional[float] = None,
              hard_factor: Optional[float] = None) -> None:
    """Per-run reset used by the facade: installs a fresh run state and
    arms the configured budget.  A pending process-wide preemption signal
    is kept: a SIGTERM that arrived while the graph was loading winds
    down the run that follows."""
    runstate.begin()
    if budget_s is not None and budget_s > 0:
        install_budget(budget_s, grace_s, hard_factor)
    sig = runstate.signal_reason()
    if sig:
        request_stop(sig)


def draining() -> str:
    """The pending process-wide preemption reason ("" when none)."""
    return runstate.signal_reason()


def agreed_stop() -> bool:
    """The wind-down verdict for control flow that gates collective work:
    the ranks' local verdicts max-reduced (agreement.agree_max), so any
    rank stopping stops all.  With one rank it is should_stop()."""
    local = should_stop()
    try:
        from .agreement import agree_max

        agreed = bool(agree_max(1 if local else 0)[0])
    except Exception:
        return local
    if agreed and not local:
        request_stop("peer")
    return agreed


def request_stop(reason: str) -> None:
    """Ask the pipeline to wind down at its next barrier (signal handlers,
    tests, the serving drain).  Safe to call from a signal handler: sets
    flags only.  Signal-shaped reasons are recorded process-wide (every
    run and the serving queue observe them); anything else stops only
    the calling thread's current run."""
    if reason in ("sigterm", "sigint", "draining"):
        runstate.signal_stop(reason)
    run = runstate.current()
    if not run.stop:
        run.stop = True
        run.reason = reason


def should_stop() -> bool:
    """True once the budget has expired, a stop was requested, or a
    process-wide preemption signal is pending.  The first True
    transition emits a ``deadline`` telemetry event and a log line
    (once), so the wind-down is visible in the run report."""
    run = runstate.current()
    if not run.stop:
        sig = runstate.signal_reason()
        if sig:
            run.stop = True
            run.reason = sig
        elif run.deadline is not None and time.monotonic() >= run.deadline:
            run.stop = True
            run.reason = run.reason or "budget"
    if run.stop and not run.announced:
        run.announced = True
        run.stage_at_stop = run.stage  # where the wind-down actually began
        _announce(run)
    return run.stop


def _announce(run) -> None:
    from .. import telemetry
    from ..utils.logger import log_warning

    telemetry.event(
        "deadline",
        reason=run.reason,
        stage=run.stage or None,
        budget_s=run.budget_s,
        elapsed_s=(
            None if run.t0 is None
            else round(time.monotonic() - run.t0, 3)
        ),
    )
    log_warning(
        f"deadline: winding down ({run.reason}) at stage "
        f"'{run.stage or 'start'}' — finishing mandatory work only"
    )


def triggered() -> bool:
    """True when the run wound down early (deadline or stop request)."""
    return runstate.current().stop


def note_stage(stage: str) -> None:
    """Record the deepest pipeline stage reached (barrier bookkeeping;
    the `anytime` annotation reports it)."""
    runstate.current().stage = stage


def stage_reached() -> str:
    return runstate.current().stage


def state() -> dict:
    """The run report's `anytime` section for a wound-down run (None
    values are omitted so the section validates against the schema's
    typed optional properties)."""
    run = runstate.current()
    d = {
        "anytime": bool(run.stop),
        "reason": run.reason or None,
        "stage": run.stage_at_stop or run.stage or None,
        "budget_s": run.budget_s,
        "grace_s": run.grace_s if run.budget_s is not None else None,
        "elapsed_s": (
            None if run.t0 is None
            else round(time.monotonic() - run.t0, 3)
        ),
    }
    return {k: v for k, v in d.items() if v is not None or k == "anytime"}


def install_signal_handlers() -> None:
    """Route SIGTERM/SIGINT into the cooperative wind-down (CLI entry
    points only — a library must not hijack the host's signals).

    First delivery requests a stop; a second delivery of the same signal
    restores the previous handler and re-raises it, so a stuck run can
    still be killed the classic way.  Idempotent."""
    if _prev_handlers:
        return

    def _handler(signum, frame):
        name = signal.Signals(signum).name
        request_stop(name.lower())
        # second delivery: give the signal back to its old handler
        prev = _prev_handlers.get(signum, signal.SIG_DFL)
        try:
            signal.signal(signum, prev)
        except (ValueError, OSError):
            pass
        # handlers may not log safely in all contexts; stderr write is
        # async-signal-tolerant enough for a one-line notice
        import sys

        sys.stderr.write(
            f"\n[{name}] wind-down requested: finishing at the next "
            "pipeline barrier (send again to force)\n"
        )

    for signum in (signal.SIGTERM, signal.SIGINT):
        try:
            _prev_handlers[signum] = signal.signal(signum, _handler)
        except (ValueError, OSError):
            # not the main thread / unsupported platform: skip silently,
            # the cooperative budget path still works
            _prev_handlers.pop(signum, None)


def uninstall_signal_handlers() -> None:
    """Restore the handlers replaced by install_signal_handlers (tests)."""
    for signum, prev in list(_prev_handlers.items()):
        try:
            signal.signal(signum, prev)
        except (ValueError, OSError):
            pass
    _prev_handlers.clear()
