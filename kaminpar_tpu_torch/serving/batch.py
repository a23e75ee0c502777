"""The CLI batch surface of the serving layer (``--serve-batch``; own
copy of kaminpar_tpu/serving/batch.py).  Every request runs on the CLI's
``--device``.

Batch spec: a JSON file that is either a bare array of request objects
or ``{"config": {...}, "requests": [...]}``.  Each request object::

    {"graph": "gen:rgg2d;n=4096;avg_degree=8;seed=1" | "path/to.metis",
     "k": 8,                  # required
     "epsilon": 0.03,         # optional
     "deadline_s": 2.0,       # optional per-request anytime budget
     "hard_deadline_s": 20.0, # optional per-request HARD wall-clock
                              # ceiling (supervision contract)
     "priority": 0,           # optional, higher runs first
     "seed": 1,               # optional
     "id": "my-request"}      # optional stable id

Session-scoped request kinds (dynamic repartitioning,
dynamic/; inproc isolation only)::

    {"kind": "register",    "session": "s1", "graph": ..., "k": 8}
    {"kind": "mutate",      "session": "s1",
     "delta": {"edge_inserts": [[0, 5]], "edge_deletes": [[1, 2]]}}
    {"kind": "repartition", "session": "s1"}   # k defaults to the
                                               # session's k

``config`` keys map onto :class:`~kaminpar_tpu.serving.service.
ServiceConfig` fields (``max_queue_depth``, ``max_queued_cost``,
``max_request_cost``, ``result_cache_entries``, ``result_cache_bytes``,
``default_deadline_s``, and the supervision knobs ``isolation``,
``hard_deadline_s``, ``hard_deadline_factor``, ``worker_max_requests``,
``worker_rss_limit_bytes``, ``heartbeat_file``, ``metrics_file``; the
CLI flags ``--serve-isolation`` / ``--heartbeat-file`` /
``--metrics-file`` override the spec).

Exit-code contract: the PROCESS outcome, not the per-request outcomes —
isolated request failures and admission rejections still exit 0 (that is
the point of the isolation boundary); only an unreadable/invalid batch
file (exit 2) or a process-fatal error is nonzero.  Per-request verdicts
land on stdout (one ``SERVED`` line each), in the final ``SERVING``
summary line, and in the run report's ``serving`` section.
"""

from __future__ import annotations

import dataclasses
import json
from typing import List, Tuple

from .service import PartitionRequest, PartitionService, ServiceConfig


class BatchSpecError(ValueError):
    """The batch file could not be parsed into requests."""


def load_batch(path: str) -> Tuple[List[PartitionRequest], ServiceConfig]:
    try:
        with open(path) as f:
            spec = json.load(f)
    except (OSError, ValueError) as e:
        raise BatchSpecError(f"unreadable batch spec {path!r}: {e}") from e
    if isinstance(spec, list):
        raw_requests, raw_config = spec, {}
    elif isinstance(spec, dict):
        raw_requests = spec.get("requests")
        raw_config = spec.get("config", {})
    else:
        raise BatchSpecError(f"{path}: batch spec must be a list or object")
    if not isinstance(raw_requests, list) or not raw_requests:
        raise BatchSpecError(f"{path}: no requests in batch spec")

    config = ServiceConfig()
    known = {f.name for f in dataclasses.fields(ServiceConfig)}
    for key, value in (raw_config or {}).items():
        if key not in known:
            raise BatchSpecError(f"{path}: unknown config key {key!r}")
        cur = getattr(config, key)
        if isinstance(cur, bool):
            # bool("false") is True — parse string booleans explicitly
            if isinstance(value, str):
                lowered = value.strip().lower()
                if lowered in ("1", "true", "yes", "on"):
                    value = True
                elif lowered in ("0", "false", "no", "off"):
                    value = False
                else:
                    raise BatchSpecError(
                        f"{path}: config {key!r} expects a boolean, "
                        f"got {value!r}"
                    )
            setattr(config, key, bool(value))
        else:
            try:
                setattr(config, key, type(cur)(value))
            except (TypeError, ValueError) as e:
                raise BatchSpecError(
                    f"{path}: bad value for config {key!r}: {e}"
                ) from e

    requests: List[PartitionRequest] = []
    for i, r in enumerate(raw_requests):
        kind = (r or {}).get("kind", "partition") \
            if isinstance(r, dict) else "partition"
        session_kind = kind in ("register", "mutate", "repartition")
        if not isinstance(r, dict) or (
            not session_kind and ("graph" not in r or "k" not in r)
        ):
            raise BatchSpecError(
                f"{path}: request #{i} needs at least 'graph' and 'k'"
            )
        if session_kind and not r.get("session"):
            raise BatchSpecError(
                f"{path}: request #{i} (kind={kind!r}) needs 'session'"
            )
        if kind == "register" and ("graph" not in r or "k" not in r):
            raise BatchSpecError(
                f"{path}: request #{i} (register) needs 'graph' and 'k'"
            )
        if kind == "mutate" and not isinstance(r.get("delta"), dict):
            raise BatchSpecError(
                f"{path}: request #{i} (mutate) needs a 'delta' object"
            )
        try:
            requests.append(PartitionRequest(
                graph=r.get("graph", ""),
                k=int(r.get("k", 0) or 0),
                kind=str(kind),
                session=str(r.get("session", "") or ""),
                delta=(r.get("delta")
                       if isinstance(r.get("delta"), dict) else None),
                # session kinds: an ABSENT epsilon means "the session's
                # contract" (register: the ctx default; repartition:
                # whatever the session was registered with), not the
                # stateless wire default
                epsilon=(
                    float(r["epsilon"])
                    if r.get("epsilon") is not None
                    else (None if session_kind else 0.03)
                ),
                deadline_s=(
                    float(r["deadline_s"])
                    if r.get("deadline_s") is not None else None
                ),
                hard_deadline_s=(
                    float(r["hard_deadline_s"])
                    if r.get("hard_deadline_s") is not None else None
                ),
                priority=int(r.get("priority", 0)),
                seed=(
                    int(r["seed"]) if r.get("seed") is not None else None
                ),
                request_id=str(r.get("id", "")) or f"req-{i + 1}",
            ))
        except (TypeError, ValueError) as e:
            # the exit-2 contract covers every malformed field, not just
            # missing ones — a bad spec must never traceback the CLI
            raise BatchSpecError(
                f"{path}: request #{i} has a malformed field: {e}"
            ) from e
    ids = [r.request_id for r in requests]
    dupes = sorted({i for i in ids if ids.count(i) > 1})
    if dupes:
        # duplicate ids would collide in the service's per-id cost/FIFO
        # maps and produce ambiguous report rows (an explicit "req-2"
        # can collide with a generated default just as easily)
        raise BatchSpecError(f"{path}: duplicate request id(s): {dupes}")
    return requests, config


def run_batch_cli(args, ctx) -> int:
    """Drive a batch through PartitionService for cli.main.  Telemetry
    and the fault-plan echo are already set up by the caller; this
    annotates the ``serving`` section and exports the requested report.
    """
    import sys
    import time

    from .. import telemetry

    try:
        requests, config = load_batch(args.serve_batch)
    except BatchSpecError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.serve_queue_depth is not None:
        config.max_queue_depth = int(args.serve_queue_depth)
    if args.serve_cost_cap is not None:
        config.max_queued_cost = float(args.serve_cost_cap)
    if getattr(args, "serve_isolation", None) is not None:
        config.isolation = str(args.serve_isolation)
    if getattr(args, "heartbeat_file", None):
        config.heartbeat_file = str(args.heartbeat_file)
    if getattr(args, "metrics_file", None):
        config.metrics_file = str(args.metrics_file)

    service = PartitionService(ctx, config, quiet=True, device=args.device)
    t0 = time.perf_counter()
    try:
        records = service.serve(requests)
    except KeyboardInterrupt:
        # a second Ctrl-C restored the default handler and surfaced here
        # mid-request: the single-shot emergency contract applies to the
        # batch too — unwind scopes, export a schema-valid report (with
        # the verdicts collected so far in its serving section), exit
        # 130.  cli._emergency_interrupt_exit annotates the anytime/
        # no-result sentinel sections and performs the export.
        from ..cli import _emergency_interrupt_exit

        service.annotate()
        service.close()
        return _emergency_interrupt_exit(args, t0)
    wall = time.perf_counter() - t0

    summary = service.annotate()
    service.close()  # release the supervised worker pool, if any
    if telemetry.enabled() and "result" not in telemetry.run_info():
        # the stream belongs to the LAST request; if it never produced a
        # result (failed/rejected/drained), the schema-required section
        # carries the explicit no-result sentinel (the emergency-report
        # idiom from cli._emergency_interrupt_exit) — per-request
        # results live in the serving section either way
        telemetry.annotate(
            result={"cut": -1, "imbalance": 0.0, "feasible": False}
        )
    if not args.quiet:
        for rec in records:
            extra = ""
            if rec.verdict in ("rejected", "failed"):
                extra = f" reason={rec.reason or rec.error}"
            elif rec.cached:
                extra = " cache=hit"
            print(
                f"SERVED id={rec.request_id} verdict={rec.verdict} "
                f"cut={rec.cut} feasible={int(rec.feasible)} "
                f"wall={rec.wall_s:.3f}s{extra}"
            )
        counts = summary["counts"]
        total_hist = (
            summary.get("latency", {}).get("phases", {}).get("total", {})
        )
        throughput = summary.get("throughput", {})
        print(
            "SERVING total={} served={} anytime={} degraded={} "
            "rejected={} failed={} worker_hang={} worker_crash={} "
            "cache_hit_rate={} p50_ms={} p95_ms={} rps={} "
            "queue_peak={} drained={} wall={:.3f}s".format(
                len(records), counts["served"], counts["anytime"],
                counts["degraded"], counts["rejected"], counts["failed"],
                counts.get("worker-hang", 0),
                counts.get("worker-crash", 0),
                summary["cache"]["hit_rate"],
                total_hist.get("p50_ms"), total_hist.get("p95_ms"),
                throughput.get("requests_per_second"),
                throughput.get("queue_peak"),
                int(summary["drained"]), wall,
            )
        )

    rc = telemetry.export_cli_outputs(
        args,
        extra_run={"serve_batch": args.serve_batch,
                   "requests": len(records),
                   "partition_seconds": round(wall, 3)},
        quiet=args.quiet,
    )
    return rc
