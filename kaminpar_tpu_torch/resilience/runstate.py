"""The per-run resilience state (own copy of
kaminpar_tpu/resilience/runstate.py).

The armed deadline, the cooperative stop verdict, the deepest stage
reached, the active checkpoint manager and the memory governor's state
live on one :class:`RunState` per run, held in a thread-local slot;
``deadline.begin_run`` installs a fresh one, so a later run never sees an
earlier run's verdicts.  Preemption signals (SIGTERM/SIGINT) are
process-wide and live in one shared slot that every run's
``should_stop()`` reads.
"""

from __future__ import annotations

import threading
from typing import Optional

#: Default declared wind-down grace on top of the budget (seconds).
DEFAULT_GRACE_S = 30.0


class RunState:
    """All resilience state owned by one run."""

    __slots__ = (
        "budget_s", "grace_s", "t0", "deadline", "stop", "reason",
        "stage", "stage_at_stop", "announced", "manager", "suspend",
        "memory", "dist", "comm",
    )

    def __init__(self) -> None:
        # deadline half (deadline.py)
        self.budget_s: Optional[float] = None
        self.grace_s: float = DEFAULT_GRACE_S
        self.t0: Optional[float] = None
        self.deadline: Optional[float] = None
        self.stop: bool = False
        self.reason: str = ""
        self.stage: str = ""
        self.stage_at_stop: str = ""
        self.announced: bool = False
        # checkpoint half (checkpoint.py)
        self.manager = None  # Optional[CheckpointManager]
        self.suspend: int = 0
        # memory governor (memory.py): None while dormant
        self.memory = None  # Optional[GovernorState]
        # divergence sentinels (agreement.py): armed only by the dist
        # driver, None for shared-memory runs
        self.dist = None  # Optional[agreement.AuditState]
        # the dist path's collective account (parallel/mesh.py), created
        # on first touch
        self.comm = None  # Optional[mesh.CommLog]


_tls = threading.local()

#: Process-wide preemption signal ("sigterm" / "sigint" / "").  Written
#: by the signal handlers with one assignment (no lock: a handler must
#: not take a mutex the interrupted thread may hold).
_signal_reason = ""


def current() -> RunState:
    """This thread's run state (created on first touch)."""
    run = getattr(_tls, "run", None)
    if run is None:
        run = _tls.run = RunState()
    return run


def begin() -> RunState:
    """Install a fresh RunState for this thread and return it."""
    run = RunState()
    _tls.run = run
    return run


def signal_stop(reason: str) -> None:
    """Record a process-wide preemption signal (async-signal-safe)."""
    global _signal_reason
    if not _signal_reason:
        _signal_reason = reason


def signal_reason() -> str:
    """The pending process-wide preemption reason ("" when none)."""
    return _signal_reason


def clear_signal() -> None:
    """Drop the process-wide signal flag."""
    global _signal_reason
    _signal_reason = ""
