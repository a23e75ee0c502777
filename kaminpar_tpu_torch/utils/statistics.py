"""Statistics counters (own copy of kaminpar_tpu/utils/statistics.py;
analog of KAMINPAR_ENABLE_STATISTICS / IFSTATS).

The reference gates detailed per-phase statistics behind a compile flag
(e.g. label_propagation.h:87,538, refinement/fm/batch_stats.cc).  Here a
process-global registry of named counters and series is toggled at run
time (the CLI's ``--statistics``); disabled, a record is one bool check.
The refiner records ``runs_<algorithm>`` and ``cut_after_<algorithm>``,
the same integers as the JAX package, and the run report's ``counters``
section is ``as_dict()``.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List

_enabled = False
_counters: Dict[str, int] = defaultdict(int)
_series: Dict[str, List[float]] = defaultdict(list)


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


def reset() -> None:
    _counters.clear()
    _series.clear()


def count(name: str, delta: int = 1) -> None:
    """IFSTATS(counter++) analog."""
    if _enabled:
        _counters[name] += delta


def track(name: str, value: float) -> None:
    """Append to a named series (per-round cuts, move counts, ...)."""
    if _enabled:
        _series[name].append(float(value))


def get(name: str) -> int:
    return _counters.get(name, 0)


def series(name: str) -> List[float]:
    return list(_series.get(name, []))


def counters_snapshot() -> Dict[str, int]:
    """Copy of the counter map (telemetry span-entry baseline)."""
    return dict(_counters)


def counters_delta(snapshot: Dict[str, int]) -> Dict[str, int]:
    """Counters that changed since `snapshot` (span counters attribute)."""
    return {
        name: value - snapshot.get(name, 0)
        for name, value in _counters.items()
        if value != snapshot.get(name, 0)
    }


def as_dict() -> dict:
    """Counters + series summaries for the run report."""
    out: dict = dict(_counters)
    for name, vals in _series.items():
        if vals:
            out[name] = {
                "n": len(vals),
                "last": vals[-1],
                "min": min(vals),
                "max": max(vals),
            }
    return out


def render() -> str:
    lines = ["STATS"]
    for name in sorted(_counters):
        lines.append(f"  {name}={_counters[name]}")
    for name in sorted(_series):
        vals = _series[name]
        lines.append(
            f"  {name}: n={len(vals)} last={vals[-1]:g} "
            f"min={min(vals):g} max={max(vals):g}"
        )
    return "\n".join(lines)
