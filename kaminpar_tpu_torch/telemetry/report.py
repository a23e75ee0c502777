"""Per-run JSON report (counterpart of kaminpar_tpu/telemetry/report.py).

One machine-readable record per partition call, in the JAX package's
schema (schema_version 14): the scope tree of the global timer, the
result metrics, per-level graph sizes and rating-engine choices (from the
coarsener's telemetry events), every event, the output gate's verdict,
the external scheme's streaming record, and an environment stamp naming
torch, its CUDA build and the card.

The resilience sections come from their modules: `faults` (the active
plan and every injected fault), `checkpoint`, `anytime` and
`memory_budget` (annotated by the facade), `integrity` (the sentinels'
counters).  `counters` holds the statistics counters (utils/statistics.py)
when they are enabled, `heap` the heap profiler's tree when it is, and
`dynamic` the delta-chain section that a chain's caller annotates
(dynamic/driver.summarize).  `serving` and `supervision` come from the
serving layer (serving/service.py annotates them after a batch;
otherwise `supervision` is read from resilience/supervisor.py), `tracing`
from telemetry/tracing.py, `comm` and `dist_resilience` from the dist
driver.  Sections fed by modules this package does not have yet (the
execution ledger, the quality observatory) carry the JAX package's
well-formed disabled defaults.  There is no XLA compile
step: `compile` is the disabled default and says so, and `perf` holds
what the card has instead, each hand-written kernel's launches (and
CUDA-event milliseconds where `_native.EVENT_LOG` was set) and the
`torch.cuda` allocation peak.

The schema is this package's copy (`run_report.schema.json`), checked by
`validate_report`.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

from . import events as _events
from . import jsonable, launches_since_reset
from . import progress_series as _progress_series
from . import run_info as _run_info

SCHEMA_VERSION = 14
SCHEMA_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "run_report.schema.json"
)

COMPILE_CAVEAT = (
    "no XLA compile on this backend: the hand-written kernels are built "
    "once by nvcc and the host libraries by g++ before the run, outside "
    "its scopes; kernel launches and times are in perf.kernels"
)
COMM_CAVEAT = ("no collectives: a single-device run (the dist path's "
               "account is parallel/mesh.py's)")
LANE_GATHER_REASON = (
    "this package has no lane-gather probe: on CUDA every gather of the "
    "path is the hand-written kernel K1 (gather_i32)"
)


def environment_stamp() -> dict:
    """Version, torch and CUDA build, and the device of the run."""
    import platform as _platform

    import torch

    from .. import __version__

    cuda = torch.cuda.is_available()
    env: Dict[str, Any] = {
        "version": __version__,
        "python": _platform.python_version(),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "platform": "gpu" if cuda else "cpu",
        "device_count": torch.cuda.device_count() if cuda else 1,
        "process_count": 1,
        "device_name": (torch.cuda.get_device_name(0) if cuda
                        else _platform.processor() or _platform.machine()),
    }
    return env


def _perf_section(levels: List[dict]) -> dict:
    """The hand-written kernels' launches since the run began (and their
    CUDA-event milliseconds where recorded), the device allocation peak,
    and the per-level CSR buffer bytes of the coarsener's level events."""
    import torch

    from .. import _native

    log = _native.EVENT_LOG
    kernels = {}
    for name, launches in launches_since_reset().items():
        event_ms = None
        if log is not None:
            event_ms = sum(a.elapsed_time(b) for a, b in log.get(name, ()))
        kernels[name] = {"launches": launches, "event_ms": event_ms}
    memory: Dict[str, Any] = {
        "levels": [
            {k: lv[k] for k in ("level", "n", "m", "n_pad", "m_pad",
                                "buffer_bytes") if k in lv}
            for lv in levels if "buffer_bytes" in lv
        ],
    }
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.synchronize()
        memory["peak_live_bytes"] = int(torch.cuda.max_memory_allocated())
        limit = int(torch.cuda.get_device_properties(0).total_memory)
        memory["hbm_limit_bytes"] = limit
        memory["headroom_bytes"] = limit - memory["peak_live_bytes"]
    return {
        "enabled": cuda,
        "caveat": (
            "launch counts come from the kernel wrappers; event_ms sums the "
            "CUDA events of each launch when _native.EVENT_LOG is set "
            "(null otherwise); peak_live_bytes is torch.cuda."
            "max_memory_allocated() since the process or the caller last "
            "reset the peak" if cuda else
            "no CUDA device: the kernels' torch twins ran, so launch "
            "counts stay 0 and no device memory is measured"
        ),
        "kernels": kernels,
        "memory": memory,
    }


def _scope_tree(node) -> dict:
    return {
        child.name: {
            "elapsed_s": round(child.elapsed, 6),
            "count": child.count,
            "children": _scope_tree(child),
        }
        for child in node.children.values()
    }


def _comm_section() -> dict:
    """The dist path's collective account (parallel/mesh.py counts calls;
    `traced_calls` carries the call count under the schema's name)."""
    from ..parallel import mesh

    records = mesh.comm_records()
    if not records:
        return {"caveat": COMM_CAVEAT, "records": []}
    phases = mesh.comm_phase_totals()
    return {
        "caveat": mesh.COMM_CAVEAT,
        "records": [dict(r, traced_calls=r["calls"]) for r in records],
        "phases": phases,
        "bytes_total": sum(p["bytes_total"] for p in phases.values()),
        "phase_opens": mesh.phase_opens(),
    }


def build_run_report(extra_run: Optional[dict] = None) -> dict:
    """Assemble the report from the current telemetry and timer state.

    Call after `compute_partition` returns (the facade annotates the run
    and result sections during the call); `extra_run` keys are merged into
    the `run` section."""
    from ..utils import heap_profiler, statistics, timer

    from ..resilience import faults, integrity
    from ..resilience.errors import CollectiveTimeout
    from . import tracing
    from ..resilience.policy import with_fallback

    info = _run_info()
    result = info.pop("result", {})
    gate_verdict = info.pop("output_gate", {"checked": False})
    external = info.pop("external", {"enabled": False})
    # the resilience sections the facade annotates; well-formed defaults
    # for a run that used none of them
    ckpt_summary = info.pop("checkpoint", {"enabled": False})
    anytime = info.pop("anytime", {"anytime": False})
    memory_budget = info.pop("memory_budget", {"enabled": False})
    # the dynamic-repartitioning audit trail (dynamic/driver.summarize),
    # annotated by the chain driver's caller
    dynamic = info.pop("dynamic", {"enabled": False})
    # the dist driver's audit trail (parallel/dist_partitioner.py)
    dist_resilience = info.pop("dist_resilience", {"enabled": False})
    # the serving layer's verdicts, admission, cache and latency
    # statistics (serving/service.py annotates them after a batch)
    serving = info.pop("serving", {"enabled": False})
    # the supervision audit trail: the serving layer annotates its
    # pool-aware view; otherwise the module state is read (a single run
    # with a heartbeat or an armed watchdog still reports), and a run
    # that configured nothing carries the disabled default
    supervision = info.pop("supervision", None)
    if supervision is None:
        from ..resilience import supervisor

        supervision = supervisor.summary()
    run = dict(info)
    if extra_run:
        run.update({k: jsonable(v) for k, v in extra_run.items()})

    levels = [
        {"level": e.attrs.get("level"), **{
            k: e.attrs[k]
            for k in ("n", "m", "retries", "n_pad", "m_pad",
                      "buffer_bytes")
            if k in e.attrs
        }}
        for e in _events("coarsening-level")
    ]
    rating_levels = [
        {k: e.attrs[k]
         for k in ("level", "engine", "reason", "avg_degree",
                   "degree_skew", "n", "m")
         if k in e.attrs}
        for e in _events("rating-engine")
    ]
    rating_counts: Dict[str, int] = {}
    for lv in rating_levels:
        eng = lv.get("engine")
        if eng:
            rating_counts[eng] = rating_counts.get(eng, 0) + 1

    def _aggregate():
        try:
            return timer.aggregate_across_processes()
        except (TypeError, AttributeError, KeyError, IndexError,
                AssertionError, NameError):
            raise  # programming errors stay loud
        except Exception as e:
            raise CollectiveTimeout(
                f"timer aggregation failed: {type(e).__name__}: {e}"
            ) from e

    # the `collective` fault site: a failed aggregation degrades the
    # report to local timers; before the event lists are read, so its
    # own `degraded` event lands in this report
    timers_aggregated = with_fallback(
        _aggregate, lambda exc: None, site="collective",
        where="report-timers",
    )

    report = {
        "schema_version": SCHEMA_VERSION,
        "environment": environment_stamp(),
        "run": run,
        "result": result,
        "scope_tree": _scope_tree(timer.GLOBAL_TIMER.root),
        "levels": levels,
        "rating": {"levels": rating_levels, "engines": rating_counts},
        "comm": _comm_section(),
        "events": [e.to_dict() for e in _events()],
        "counters": statistics.as_dict() if statistics.enabled() else {},
        "lane_gather": {"mode": "not-probed", "reason": LANE_GATHER_REASON},
        "faults": faults.plan_summary(),
        "degraded": [e.to_dict() for e in _events("degraded")],
        "output_gate": gate_verdict,
        "progress": [p.to_dict() for p in _progress_series()],
        "compile": {"caveat": COMPILE_CAVEAT, "totals": {}, "phases": {}},
        "checkpoint": ckpt_summary,
        "anytime": anytime,
        "serving": serving,
        "perf": _perf_section(levels),
        "memory_budget": memory_budget,
        "quality": {"enabled": False,
                    "caveat": "quality observatory unavailable"},
        "dist_resilience": dist_resilience,
        "external": external,
        "supervision": supervision,
        "dynamic": dynamic,
        "tracing": tracing.snapshot(),
        "ledger": {"enabled": False,
                   "caveat": "execution ledger unavailable"},
        "integrity": integrity.summary(),
    }
    if timers_aggregated is not None:
        report["timers_aggregated"] = timers_aggregated
    if heap_profiler.profiling_enabled():
        report["heap"] = heap_profiler.tree_dict()
    return report


def write_run_report(path: str, extra_run: Optional[dict] = None) -> dict:
    """Build the report, write it to `path`, and return it."""
    report = build_run_report(extra_run=extra_run)
    with open(path, "w") as f:
        json.dump(report, f, indent=1)
    return report


# --- schema check (scripts/check_report_schema.py's subset) ----------------

_TYPES = {
    "object": dict,
    "array": list,
    "string": str,
    "number": (int, float),
    "integer": int,
    "boolean": bool,
    "null": type(None),
}


def _type_ok(value: Any, expected) -> bool:
    if isinstance(expected, list):
        return any(_type_ok(value, e) for e in expected)
    py = _TYPES.get(expected)
    if py is None:
        return True
    if expected in ("integer", "number") and isinstance(value, bool):
        return False  # bool is an int subclass in Python; JSON disagrees
    return isinstance(value, py)


def _violations(instance: Any, schema: dict, path: str) -> List[str]:
    errors: List[str] = []
    expected = schema.get("type")
    if expected is not None and not _type_ok(instance, expected):
        return [f"{path}: expected {expected}, got {type(instance).__name__}"]
    enum = schema.get("enum")
    if enum is not None and instance not in enum:
        errors.append(f"{path}: value {instance!r} not in enum {enum}")
    if isinstance(instance, dict):
        for req in schema.get("required", []):
            if req not in instance:
                errors.append(f"{path}: missing required key {req!r}")
        for key, sub in schema.get("properties", {}).items():
            if key in instance:
                errors.extend(_violations(instance[key], sub, f"{path}.{key}"))
    if isinstance(instance, list) and schema.get("items"):
        for i, item in enumerate(instance):
            errors.extend(_violations(item, schema["items"], f"{path}[{i}]"))
    return errors


def validate_report(report: dict, schema: Optional[dict] = None) -> List[str]:
    """The report's violations of the schema (empty: valid)."""
    if schema is None:
        with open(SCHEMA_PATH) as f:
            schema = json.load(f)
    return _violations(report, schema, "$")
