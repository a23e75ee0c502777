"""Chrome trace-event exporter (`--trace-out`; own copy of
kaminpar_tpu/telemetry/chrome_trace.py).

Serializes the telemetry stream to the Chrome trace-event JSON object
format (the `{"traceEvents": [...]}` flavor Perfetto and chrome://tracing
both read): every closed span becomes a complete ("ph": "X") event, every
one-shot decision an instant ("ph": "i") event, every progress series a
counter ("ph": "C") track, and every request trace (telemetry/tracing.py)
a process track of its own, with the service's spans and the supervised
worker's on two threads.  Tracks carry `process_name` / `thread_name`
metadata ("ph": "M").

The JAX package gathers the streams of several host processes; this
package is one process that drives every shard (parallel/mesh.py), so the
gather is the local stream under process 0, the rank model of
resilience/agreement.py.  The counter tracks that the JAX package draws
from its quality, memory-watermark and transfer-ledger events wait for
those modules (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import json
from typing import List, Tuple

from . import events as _events
from . import progress_series as _progress_series
from . import spans as _spans


def _local_payload() -> dict:
    return {
        "spans": [s.to_dict() for s in _spans()],
        "events": [e.to_dict() for e in _events()],
        "progress": [p.to_dict() for p in _progress_series()],
    }


def gather_payloads() -> List[Tuple[int, dict]]:
    """[(process index, {"spans": [...], "events": [...], "progress":
    [...]})] across the processes of the run: this package's one."""
    from ..resilience.agreement import process_count, process_index

    assert process_count() == 1
    return [(process_index(), _local_payload())]


def _counter_events(pid: int, series: dict) -> List[dict]:
    """Counter ("ph": "C") events for one progress series: iteration
    values spread uniformly over the loop's [t0, t1] wall window (the
    series keeps no per-iteration stamps; the spread places the curve
    under the span that produced it)."""
    out: List[dict] = []
    t0 = float(series.get("t0", 0.0))
    t1 = max(float(series.get("t1", t0)), t0)
    names = list(series.get("series", {}).keys())
    n = int(series.get("iterations", 0))
    if not names or n <= 0:
        return out
    kind = series.get("kind", "progress")
    step = (t1 - t0) / n
    for stat in names:
        vals = series["series"][stat]
        for i, v in enumerate(vals[:n]):
            out.append(
                {
                    "ph": "C",
                    "cat": "progress",
                    "name": f"{kind}.{stat}",
                    "ts": round((t0 + (i + 1) * step) * 1e6, 3),
                    "pid": pid,
                    "tid": 0,
                    "args": {stat: v},
                }
            )
    return out


def chrome_trace() -> dict:
    """The trace-event JSON object for the current stream."""
    trace_events: List[dict] = []
    for pid, payload in gather_payloads():
        # rank-labeled metadata tracks: the pid is the process index,
        # so "rank N" reads directly in Perfetto
        trace_events.append(
            {
                "ph": "M",
                "name": "process_name",
                "pid": pid,
                "tid": 0,
                "args": {"name": f"kaminpar-tpu rank {pid}"},
            }
        )
        tids = sorted({int(s.get("tid", 0)) for s in payload["spans"]} | {0})
        for t in tids:
            trace_events.append(
                {
                    "ph": "M",
                    "name": "thread_name",
                    "pid": pid,
                    "tid": t,
                    "args": {"name": "main" if t == 0 else f"worker-{t}"},
                }
            )
        for s in payload["spans"]:
            trace_events.append(
                {
                    "ph": "X",
                    "cat": "span",
                    "name": s["name"],
                    "ts": round(s["start"] * 1e6, 3),
                    "dur": round(s["duration"] * 1e6, 3),
                    "pid": pid,
                    "tid": int(s.get("tid", 0)),
                    "args": {"path": s["path"], **s.get("attrs", {})},
                }
            )
        for e in payload["events"]:
            trace_events.append(
                {
                    "ph": "i",
                    "s": "p",  # process-scoped instant
                    "cat": "event",
                    "name": e["name"],
                    "ts": round(e["t"] * 1e6, 3),
                    "pid": pid,
                    "tid": 0,
                    "args": e.get("attrs", {}),
                }
            )
        for series in payload.get("progress", []):
            trace_events.extend(_counter_events(pid, series))
    trace_events.extend(_request_trace_events())
    return {"traceEvents": trace_events, "displayTimeUnit": "ms"}


#: pid offset of the per-request trace tracks — far above any real
#: process index so request timelines never collide with rank tracks.
_REQUEST_PID_BASE = 1000


def _request_trace_events() -> List[dict]:
    """Per-request trace timelines (telemetry/tracing.py) as their own
    Perfetto tracks: one pid per request, service spans on tid 0 and
    worker-origin spans on tid 1 — the spawn/ship overhead span and the
    worker's re-based scopes read directly against the service-side
    compute span above them."""
    from . import tracing as _tracing

    out: List[dict] = []
    for i, tr in enumerate(_tracing.traces()):
        spans = tr.get("spans") or []
        if not spans:
            continue
        pid = _REQUEST_PID_BASE + i
        out.append(
            {
                "ph": "M",
                "name": "process_name",
                "pid": pid,
                "tid": 0,
                "args": {"name": f"request {tr.get('request_id', '?')}"},
            }
        )
        for tid, label in ((0, "service"), (1, "worker")):
            out.append(
                {
                    "ph": "M",
                    "name": "thread_name",
                    "pid": pid,
                    "tid": tid,
                    "args": {"name": label},
                }
            )
        for s in spans:
            out.append(
                {
                    "ph": "X",
                    "cat": "request",
                    "name": s["name"],
                    "ts": round(float(s["start_ms"]) * 1e3, 3),
                    "dur": round(float(s["duration_ms"]) * 1e3, 3),
                    "pid": pid,
                    "tid": 1 if s.get("origin") == "worker" else 0,
                    "args": {
                        "trace_id": tr.get("trace_id", ""),
                        **(s.get("attrs") or {}),
                    },
                }
            )
    return out


def write_chrome_trace(path: str) -> None:
    """Write the trace to `path` (open in Perfetto: ui.perfetto.dev)."""
    trace = chrome_trace()
    with open(path, "w") as f:
        json.dump(trace, f)
