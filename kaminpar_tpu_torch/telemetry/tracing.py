"""End-to-end request tracing: per-request trace ids and span timelines
(own copy of kaminpar_tpu/telemetry/tracing.py).

The span stream (telemetry/__init__.py) says where this process's wall
went, per timer scope; a serving operator needs the per-request twin: one
trace id per :class:`PartitionRequest`, with spans for admission, queue
wait, resolve, compute and gate, across the supervised worker's process
boundary (a ``--serve-isolation process`` request shows its spawn and
ship overhead next to the worker's own scopes), and with the spans that
deep layers attach to the current trace (the dist compute, the external
stream).

Traces live in this module's own bounded store, not in the telemetry
stream: the facade resets the stream at every request, but a batch's
traces must survive until the batch report is built.
``telemetry.reset()`` does not touch them; :func:`reset_traces` clears
them.

Tracing is active iff telemetry is enabled: :func:`new_trace` returns ""
while it is off and every recording helper returns at once on a falsy
trace id.  Everything here is host-side bookkeeping.

At the worker boundary (resilience/supervisor.py) the worker harvests its
own depth-1 spans (:func:`harvest_worker_rows`, worker-relative ms,
origin "worker") and ships them with its result; the parent re-bases them
into the request's timeline with :func:`record_worker_reply`, which also
records a "worker-spawn-ship" span of the round trip the worker cannot
see (a cold worker's spawn, the graph's npz, the pipe).
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional

from . import enabled as _telemetry_enabled
from . import jsonable

#: Bounded trace store: oldest traces are evicted past this count (a
#: long-lived service must not grow without bound; 256 comfortably
#: covers a batch report).
MAX_TRACES = 256

#: Per-trace span cap — a pathological repair loop cannot balloon the
#: report section.
MAX_SPANS_PER_TRACE = 128

_lock = threading.Lock()
_counter = itertools.count(1)
_traces: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()

#: The trace the CURRENT run belongs to (thread-local: the serving
#: layer executes serially but submit() producers may be concurrent).
#: Deep layers that never see the request object — the dist driver's
#: rank rollup, the dynamic session commit — attach rank/session
#: annotated spans to whatever trace is current without any plumbing.
_tls = threading.local()


def set_current(trace_id: str) -> None:
    """Install ("") / clear the executing request's trace id for this
    thread — the deep-layer span hook point."""
    _tls.trace_id = trace_id or ""


def current() -> str:
    """This thread's executing trace id ("" when none)."""
    return getattr(_tls, "trace_id", "")


def enabled() -> bool:
    """Tracing rides the telemetry master switch."""
    return _telemetry_enabled()


def new_trace(request_id: str, **attrs: Any) -> str:
    """Open a trace for one request and return its id ("" while
    telemetry is disabled — callers thread the falsy id through and
    every later helper no-ops)."""
    if not enabled():
        return ""
    trace_id = f"tr-{os.getpid()}-{next(_counter)}"
    entry = {
        "trace_id": trace_id,
        "request_id": str(request_id),
        "t0": time.perf_counter(),
        "spans": [],
        "attrs": {k: jsonable(v) for k, v in attrs.items()
                  if v is not None},
    }
    with _lock:
        _traces[trace_id] = entry
        while len(_traces) > MAX_TRACES:
            _traces.popitem(last=False)
    return trace_id


def span(trace_id: str, name: str, start: Optional[float] = None,
         duration_s: float = 0.0, origin: str = "service",
         **attrs: Any) -> None:
    """Record one span.  ``start`` is a time.perf_counter() stamp
    (defaults to now - duration); stored relative to the trace's t0 in
    milliseconds."""
    if not trace_id:
        return
    with _lock:
        entry = _traces.get(trace_id)
        if entry is None or len(entry["spans"]) >= MAX_SPANS_PER_TRACE:
            return
        if start is None:
            start = time.perf_counter() - max(float(duration_s), 0.0)
        entry["spans"].append({
            "name": str(name),
            "origin": str(origin),
            "start_ms": round((start - entry["t0"]) * 1000.0, 3),
            "duration_ms": round(max(float(duration_s), 0.0) * 1000.0, 3),
            "attrs": {k: jsonable(v) for k, v in attrs.items()
                      if v is not None},
        })


def annotate(trace_id: str, **attrs: Any) -> None:
    """Attach request-level key/values to a trace (verdict, class, k)."""
    if not trace_id:
        return
    with _lock:
        entry = _traces.get(trace_id)
        if entry is not None:
            entry["attrs"].update(
                {k: jsonable(v) for k, v in attrs.items()
                 if v is not None}
            )


# ---------------------------------------------------------------------------
# the supervised-worker boundary
# ---------------------------------------------------------------------------


def harvest_worker_rows(max_rows: int = 48) -> List[dict]:
    """Called INSIDE a supervised worker after compute: its depth-1
    telemetry spans (path without a dot — the top-level timer scopes,
    e.g. ``partitioning``) as marshal-ready rows with worker-relative
    start_ms and origin "worker".  The worker's telemetry stream was
    reset at request start, so these stamps are relative to the
    request's own compute window."""
    from . import spans as _spans

    rows: List[dict] = []
    pid = os.getpid()
    for s in _spans():
        if "." in s.path:
            continue
        rows.append({
            "name": s.name,
            "origin": "worker",
            "start_ms": round(s.start * 1000.0, 3),
            "duration_ms": round(s.duration * 1000.0, 3),
            "attrs": {**s.attrs, "worker_pid": pid},
        })
        if len(rows) >= max_rows:
            break
    return rows


def record_worker_reply(trace_id: str, rows: List[dict], t_send: float,
                        roundtrip_s: float, worker_wall_s: float,
                        worker_pid: Optional[int] = None) -> None:
    """Parent-side merge of a worker's marshalled span rows: record the
    spawn/ship overhead span (roundtrip wall minus the worker's own
    wall — the containment boundary's price), then re-base each worker
    row into this trace's timeline after that overhead."""
    if not trace_id:
        return
    overhead_s = max(float(roundtrip_s) - float(worker_wall_s), 0.0)
    span(
        trace_id, "worker-spawn-ship", start=t_send,
        duration_s=overhead_s, origin="service",
        worker_pid=worker_pid,
    )
    with _lock:
        entry = _traces.get(trace_id)
        if entry is None:
            return
        base_ms = (t_send - entry["t0"] + overhead_s) * 1000.0
        for row in rows or []:
            if len(entry["spans"]) >= MAX_SPANS_PER_TRACE:
                break
            entry["spans"].append({
                "name": str(row.get("name", "")),
                "origin": str(row.get("origin", "worker")),
                "start_ms": round(
                    base_ms + float(row.get("start_ms", 0.0)), 3
                ),
                "duration_ms": round(
                    float(row.get("duration_ms", 0.0)), 3
                ),
                "attrs": {
                    k: jsonable(v)
                    for k, v in (row.get("attrs") or {}).items()
                },
            })


# ---------------------------------------------------------------------------
# consumers
# ---------------------------------------------------------------------------


def get(trace_id: str) -> Optional[dict]:
    with _lock:
        entry = _traces.get(trace_id)
        return _public(entry) if entry is not None else None


def traces() -> List[dict]:
    with _lock:
        return [_public(e) for e in _traces.values()]


def _public(entry: Dict[str, Any]) -> dict:
    return {
        "trace_id": entry["trace_id"],
        "request_id": entry["request_id"],
        "spans": [dict(s) for s in entry["spans"]],
        "attrs": dict(entry["attrs"]),
    }


def snapshot() -> dict:
    """The run report's ``tracing`` section (schema v12)."""
    return {"enabled": enabled(), "traces": traces()}


def reset_traces() -> None:
    """Explicit clear — deliberately NOT wired into telemetry.reset()
    (the serving facade resets the stream per request mid-batch; traces
    must outlive that to reach the batch report)."""
    with _lock:
        _traces.clear()
