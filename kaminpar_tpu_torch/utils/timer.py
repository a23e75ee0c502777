"""Hierarchical timer (counterpart of kaminpar_tpu/utils/timer.py;
kaminpar-common/timer.{h,cc}).

A tree of named scopes; `scoped_timer` is a context manager.  A scope
given ``sync=`` (a torch device or tensor) waits for that CUDA device at
its exit, so the scope's wall includes the device work queued inside it;
on the CPU there is nothing to wait for.  Every closed scope is also
published as a telemetry span, and the multilevel schemes' phase walls
(`last_timings`) are read off the same scopes.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Optional

from .. import telemetry


@dataclass
class TimerNode:
    name: str
    elapsed: float = 0.0
    count: int = 0
    children: Dict[str, "TimerNode"] = field(default_factory=dict)

    def child(self, name: str) -> "TimerNode":
        node = self.children.get(name)
        if node is None:
            node = TimerNode(name)
            self.children[name] = node
        return node


@dataclass
class ScopeTiming:
    """What a scope yields: its wall seconds once it has closed."""

    elapsed: float = 0.0


def _synchronize(sync) -> None:
    import torch

    device = getattr(sync, "device", sync)
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Timer:
    """Hierarchical wall-clock timer tree."""

    def __init__(self, name: str = "root") -> None:
        self.root = TimerNode(name)
        self._stack = [self.root]

    def reset(self) -> None:
        """Clear the tree; a no-op while scopes are open (a nested run
        must not orphan the outer run's stack)."""
        if len(self._stack) > 1:
            return
        self.root = TimerNode(self.root.name)
        self._stack = [self.root]

    def idle(self) -> bool:
        """True when no scope is open, i.e. not nested inside another
        pipeline."""
        return len(self._stack) == 1

    def current_path(self) -> str:
        return ".".join(n.name for n in self._stack[1:])

    @contextmanager
    def scope(self, name: str, sync=None):
        """Time a named scope; `sync` is a device (or a tensor on it)
        to synchronize at exit."""
        timing = ScopeTiming()
        node = self._stack[-1].child(name)
        self._stack.append(node)
        start = time.perf_counter()
        try:
            yield timing
        finally:
            sync_s = None
            if sync is not None:
                t_sync = time.perf_counter()
                _synchronize(sync)
                sync_s = time.perf_counter() - t_sync
            end = time.perf_counter()
            timing.elapsed = end - start
            node.elapsed += timing.elapsed
            node.count += 1
            if telemetry.enabled():
                telemetry.record_span(
                    name, self.current_path(), start, end - start,
                    sync_s=None if sync_s is None else round(sync_s, 6),
                )
            self._stack.pop()

    def unwind_to(self, depth: int) -> int:
        """Close open scopes until the stack holds ``depth`` entries (the
        memory governor's per-rung unwind); their time so far is not
        added.  Returns the number closed."""
        closed = 0
        while len(self._stack) > max(1, depth):
            self._stack.pop()
            closed += 1
        return closed

    def elapsed(self, *path: str) -> float:
        node = self.root
        for name in path:
            if name not in node.children:
                return 0.0
            node = node.children[name]
        return node.elapsed


GLOBAL_TIMER = Timer()


@contextmanager
def scoped_timer(name: str, timer: Optional[Timer] = None, sync=None):
    t = timer if timer is not None else GLOBAL_TIMER
    with t.scope(name, sync=sync) as timing:
        yield timing


def aggregate_across_processes(timer: Optional[Timer] = None) -> dict:
    """Per-scope {dotted_path: {min, avg, max, count}} across processes
    (kaminpar-dist/timer.cc's finalize).  The port runs in one process,
    so min == avg == max."""
    t = timer if timer is not None else GLOBAL_TIMER
    out = {}

    def rec(node: TimerNode, path: str) -> None:
        for child in node.children.values():
            child_path = f"{path}.{child.name}" if path else child.name
            s = float(child.elapsed)
            out[child_path] = {"min": s, "avg": s, "max": s,
                               "count": int(child.count)}
            rec(child, child_path)

    rec(t.root, "")
    return out


def render_aggregated(agg: dict) -> str:
    """Human-readable min/avg/max table (timer.cc's finalized output)."""
    lines = []
    for path, s in agg.items():
        depth = path.count(".")
        name = path.rsplit(".", 1)[-1]
        lines.append(
            f"{'  ' * (depth + 1)}{name}: min={s['min']:.4f} "
            f"avg={s['avg']:.4f} max={s['max']:.4f} s"
            + (f" ({s['count']}x)" if s["count"] > 1 else "")
        )
    return "\n".join(lines)
