"""Telemetry core (counterpart of kaminpar_tpu/telemetry/__init__.py):
spans, one-shot decision events, progress series and run annotations.

Every `utils.timer` scope exit publishes a *span* (name, dotted path,
wall time, the seconds its device synchronize took), and discrete runtime
decisions are recorded as one-shot *events* under the JAX package's names
and attributes: the coarsener's `rating-engine` and `coarsening-level`,
the deep scheme's `extend-partition`, the v-cycle's `vcycle`, the RB
scheme's `rb-bisection`, the refiner's `balancer-host-fallback`, the
native FM's `fm-refused`, the output gate's `output-gate` and the
external scheme's `stream`.  `telemetry.report` turns the stream into the
JAX package's per-run JSON report; `telemetry.diff` compares two reports.

The port runs in one process, which writes every file.  Disabled (the
default) the layer is free: producers guard on one module bool and record
nothing.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List

_enabled = False

_lock = threading.Lock()
_epoch = time.perf_counter()
_spans: List["Span"] = []
_events: List["Event"] = []
_progress: List["ProgressSeries"] = []
_run_info: Dict[str, Any] = {}
_tids: Dict[int, int] = {}
# each kernel wrapper's launch count at the last reset(): the run
# report's kernel table counts from there
_launches_at_reset: Dict[str, int] = {}


@dataclass
class Span:
    """One closed timer scope (the stream twin of a TimerNode visit)."""

    name: str
    path: str  # dotted scope path, identical to the timer tree's paths
    start: float  # seconds since the run epoch
    duration: float  # wall seconds
    tid: int = 0
    attrs: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "path": self.path,
            "start": self.start,
            "duration": self.duration,
            "tid": self.tid,
            "attrs": self.attrs,
        }


@dataclass
class Event:
    """One discrete decision (engine choice, refusal, fallback)."""

    name: str
    t: float  # seconds since the run epoch
    attrs: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {"name": self.name, "t": self.t, "attrs": self.attrs}


@dataclass
class ProgressSeries:
    """Per-iteration convergence series of one algorithm loop run:
    parallel same-length lists keyed by stat name, plus the dotted scope
    path of the enclosing timer scope."""

    kind: str
    path: str
    t0: float
    t1: float
    iterations: int
    series: Dict[str, List[Any]] = field(default_factory=dict)
    attrs: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "kind": self.kind,
            "path": self.path,
            "t0": self.t0,
            "t1": self.t1,
            "iterations": self.iterations,
            "series": self.series,
            "attrs": self.attrs,
        }


def enabled() -> bool:
    return _enabled


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def kernel_launches() -> Dict[str, int]:
    """Each hand-written kernel's wrapper launch count in this process."""
    from ..ops import gather, rating

    return {
        fn.__name__: int(fn.launches)
        for fn in (gather.gather_i32, gather.dense_block_ratings,
                   rating.best_from_slots, rating.scatter_best_from_slots)
    }


def launches_since_reset() -> Dict[str, int]:
    now = kernel_launches()
    return {name: now[name] - _launches_at_reset.get(name, 0)
            for name in now}


def reset() -> None:
    """Clear the stream and restart the run epoch (enable state is kept).

    Callers that may run nested inside another pipeline must guard with
    `utils.timer.GLOBAL_TIMER.idle()`, as the timer's own reset does."""
    global _epoch
    launches = kernel_launches()
    with _lock:
        _spans.clear()
        _events.clear()
        _progress.clear()
        _run_info.clear()
        _tids.clear()
        _launches_at_reset.clear()
        _launches_at_reset.update(launches)
        _epoch = time.perf_counter()


def jsonable(v: Any) -> Any:
    """Coerce attribute values to JSON-clean types (numpy and torch
    scalars and arrays included); anything exotic degrades to str."""
    if v is None or isinstance(v, (str, bool, int, float)):
        return v
    if isinstance(v, dict):
        return {str(k): jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [jsonable(x) for x in v]
    for conv in ("item", "tolist"):
        fn = getattr(v, conv, None)
        if callable(fn):
            try:
                return jsonable(fn())
            except Exception:
                pass
    return str(v)


def _tid() -> int:
    ident = threading.get_ident()
    t = _tids.get(ident)
    if t is None:
        t = _tids[ident] = len(_tids)
    return t


def record_span(name: str, path: str, start: float, duration: float,
                **attrs: Any) -> None:
    """Record a closed scope.  `start` is a time.perf_counter() stamp."""
    if not _enabled:
        return
    clean = {k: jsonable(v) for k, v in attrs.items() if v is not None}
    with _lock:
        _spans.append(
            Span(name, path, start - _epoch, duration, _tid(), clean)
        )


def event(name: str, **attrs: Any) -> None:
    """Record a one-shot event at the current time."""
    if not _enabled:
        return
    clean = {k: jsonable(v) for k, v in attrs.items() if v is not None}
    with _lock:
        _events.append(Event(name, time.perf_counter() - _epoch, clean))


def current_scope_path() -> str:
    """Dotted path of the open timer-scope stack ("" at top level)."""
    from ..utils.timer import GLOBAL_TIMER

    return GLOBAL_TIMER.current_path()


def record_progress(kind: str, series: Dict[str, list], iterations: int,
                    t0: float | None = None, **attrs: Any) -> None:
    """Record one per-iteration convergence series."""
    if not _enabled:
        return
    t1 = time.perf_counter() - _epoch
    clean = {k: jsonable(v) for k, v in attrs.items() if v is not None}
    entry = ProgressSeries(
        kind=kind,
        path=current_scope_path(),
        t0=(t0 - _epoch) if t0 is not None else t1,
        t1=t1,
        iterations=int(iterations),
        series={str(k): jsonable(v) for k, v in series.items()},
        attrs=clean,
    )
    with _lock:
        _progress.append(entry)


def progress_series(kind: str | None = None) -> List[ProgressSeries]:
    with _lock:
        out = list(_progress)
    if kind is not None:
        out = [p for p in out if p.kind == kind]
    return out


def annotate(**kv: Any) -> None:
    """Attach run-level key/values (preset, k, result metrics, ...) that
    the run report surfaces as its `run` / `result` sections."""
    if not _enabled:
        return
    clean = {k: jsonable(v) for k, v in kv.items()}
    with _lock:
        _run_info.update(clean)


def spans() -> List[Span]:
    with _lock:
        return list(_spans)


def events(name: str | None = None) -> List[Event]:
    with _lock:
        evs = list(_events)
    if name is not None:
        evs = [e for e in evs if e.name == name]
    return evs


def run_info() -> Dict[str, Any]:
    with _lock:
        return dict(_run_info)


def gate_verdict() -> Any:
    """The current stream's output-gate verdict as a tri-state:
    True/False when the gate checked this run's partition, None when it
    never ran (gate disabled, no partition in this stream)."""
    gate = run_info().get("output_gate")
    if isinstance(gate, dict) and gate.get("checked"):
        return bool(gate.get("valid"))
    return None


# --- shared CLI surface ----------------------------------------------------


def add_cli_args(parser) -> None:
    """The --trace-out, --report-json and --diff-* flags of a command
    line."""
    parser.add_argument(
        "--trace-out", default=None, metavar="PATH",
        help="write a Chrome trace-event JSON of the run (open in "
        "Perfetto / chrome://tracing; one track per process and per "
        "served request); enables telemetry",
    )
    parser.add_argument(
        "--report-json", default=None, metavar="PATH",
        help="write the per-run JSON report (scope tree, result metrics, "
        "events; schema: kaminpar_tpu_torch/telemetry/"
        "run_report.schema.json); enables telemetry",
    )
    parser.add_argument(
        "--diff-base", default=None, metavar="BASE.report.json",
        help="after the run, diff this run's --report-json against a "
        "baseline report (telemetry.diff) and exit non-zero past the "
        "regression thresholds; requires --report-json",
    )
    parser.add_argument(
        "--diff-wall-threshold", type=float, default=None, metavar="FRAC",
        help="fractional wall-time regression tolerated by --diff-base "
        "(default 0.10)",
    )
    parser.add_argument(
        "--diff-cut-threshold", type=float, default=None, metavar="FRAC",
        help="fractional edge-cut regression tolerated by --diff-base "
        "(default 0.10)",
    )


def enable_if_requested(args) -> None:
    """Enable telemetry when either output flag was given."""
    if getattr(args, "trace_out", None) or getattr(args, "report_json", None):
        enable()


def export_cli_outputs(args, extra_run=None, quiet: bool = False) -> int:
    """Write the files requested via add_cli_args (no-op without flags).
    Returns a process exit code: 0 normally; with --diff-base, the
    telemetry.diff verdict against the baseline report."""
    if getattr(args, "trace_out", None):
        from .chrome_trace import write_chrome_trace

        write_chrome_trace(args.trace_out)
        if not quiet:
            print(f"TRACE written to {args.trace_out} (open in Perfetto)")
    if getattr(args, "report_json", None):
        from .report import write_run_report

        write_run_report(args.report_json, extra_run=extra_run)
        if not quiet:
            print(f"REPORT written to {args.report_json}")
    if getattr(args, "diff_base", None):
        if not getattr(args, "report_json", None):
            import sys

            print("error: --diff-base requires --report-json",
                  file=sys.stderr)
            return 2
        from .diff import main as diff_main

        argv = [args.diff_base, args.report_json]
        if getattr(args, "diff_wall_threshold", None) is not None:
            argv += ["--wall-threshold", str(args.diff_wall_threshold)]
        if getattr(args, "diff_cut_threshold", None) is not None:
            argv += ["--cut-threshold", str(args.diff_cut_threshold)]
        if quiet:
            argv.append("--quiet")
        return diff_main(argv)
    return 0
