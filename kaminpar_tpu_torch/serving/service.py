"""The PartitionService: bounded queue, admission control, isolation (own
copy of kaminpar_tpu/serving/service.py).

Requests are *submitted* (admission-controlled, cheap) and then
*executed* serially on the caller's thread: the card is one device, so
the concurrency control is the bounded queue and the admission policy,
not a thread pool.  Every request runs on the service's ``device`` (the
card unless the caller asks for the CPU) inside a fault-isolation
boundary: classified failures (``resilience.errors``), malformed inputs
(``io.GraphFormatError``) and parameter errors give a structured
``failed``/``rejected`` record for *that request*, and the service keeps
serving.  Only process-fatal conditions (``KeyboardInterrupt``,
``SystemExit``, the checkpoints' ``SimulatedPreemption``) propagate.

Isolation guarantees:

  * resilience state is per run: each request's deadline and checkpoint
    state lives on a fresh :class:`~..resilience.runstate.RunState`, so
    request N neither consumes request N-1's resume state nor inherits
    its stop verdict;
  * per-request contexts are deep copies of the service's base context
    with the checkpoint and resume knobs cleared: the result cache is the
    durability story here, and two requests never share a manifest;
  * repeated crash-shaped failures in one request *class* (the padded
    (n, m, k) bucket) open a per-class breaker: later requests of that
    class are rejected at admission while other classes keep serving.

Draining: a process-wide preemption signal (SIGTERM/SIGINT through the
CLI's handlers, or :meth:`PartitionService.drain`) puts the service in
drain mode: the request in flight winds down through the anytime
deadline (verdict ``anytime``), queued requests are rejected with reason
``draining``, and every verdict still lands in the report.

On the card a request's peak device memory is read around it
(``torch.cuda.reset_peak_memory_stats`` / ``max_memory_allocated``), not
since process start: the caching allocator keeps its blocks between
requests.  Each :class:`RequestRecord` carries it, and a
process-isolated request's record carries the kernel launches its worker
made (and, where the caller times launches, their CUDA-event ms).
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from .. import caching, telemetry
from ..resilience import errors as res_errors
from ..resilience import deadline as deadline_mod
from ..resilience import with_fallback
from ..resilience.policy import BREAKER_THRESHOLD

#: The verdict taxonomy, in severity order (docs/robustness.md).
VERDICTS = ("served", "anytime", "degraded", "rejected", "failed")

#: Estimated cost (bytes of device footprint, resilience/memory.py's
#: estimator) assumed for a request whose input cannot be sized without
#: loading it (an opaque file path of unknown content).
DEFAULT_COST = float(256 << 20)

#: Device-footprint bytes assumed per byte of an on-disk graph file
#: (admission never loads the file): text formats run ~8 bytes per edge
#: token against ~12-24 padded device bytes per edge plus working set.
FILE_COST_FACTOR = 4.0


@dataclass
class PartitionRequest:
    """One unit of service work: a graph source plus (k, eps) and QoS.

    ``graph`` may be a loaded HostGraph/CompressedHostGraph, a
    ``gen:...`` generator spec, or a file path (loaded inside the
    request's isolation boundary — a malformed file fails the request,
    not the submit call)."""

    graph: Any
    k: int
    #: balance tolerance; for SESSION kinds, None means "the session's
    #: contract" (register: the service ctx default; repartition: the
    #: epsilon the session was registered with)
    epsilon: Optional[float] = 0.03
    #: request kind (dynamic repartitioning, dynamic/):
    #: "partition" (the stateless default), or the session-scoped kinds
    #: "register" (create a session from ``graph`` + compute its
    #: initial partition), "mutate" (apply ``delta`` to ``session``),
    #: "repartition" (warm/cold repartition of ``session``; ``graph``
    #: is ignored for mutate/repartition)
    kind: str = "partition"
    #: session id for the session-scoped kinds
    session: str = ""
    #: DeltaBatch wire dict for kind="mutate" (parsed inside the
    #: isolation boundary — a malformed delta fails the request)
    delta: Optional[dict] = None
    deadline_s: Optional[float] = None  # per-request anytime budget
    #: explicit per-request HARD wall-clock ceiling (supervision
    #: contract): overrides the service-level hard_deadline_s and the
    #: factor-derived ceiling; None = resolve from the config
    hard_deadline_s: Optional[float] = None
    priority: int = 0  # higher runs first
    seed: Optional[int] = None
    request_id: str = ""

    _counter = itertools.count(1)

    def __post_init__(self) -> None:
        if not self.request_id:
            self.request_id = f"req-{next(self._counter)}"


@dataclass
class RequestRecord:
    """One request's verdict — the row that lands in the run report's
    ``serving.requests`` array (and, for rejected requests, the whole
    story: nothing else ever ran)."""

    request_id: str
    verdict: str  # one of VERDICTS
    reason: str = ""  # rejection/failure/anytime reason
    error: str = ""  # structured error type for failed requests
    detail: str = ""  # truncated error message
    k: int = 0
    n: int = -1  # -1: input never resolved (rejected before load)
    m: int = -1
    cut: int = -1
    imbalance: float = 0.0
    feasible: bool = False
    gate_valid: Optional[bool] = None
    cached: bool = False
    bucket: str = ""  # executable bucket key "n_pad/m_pad/k_pad"
    degraded_sites: List[str] = field(default_factory=list)
    wall_s: float = 0.0
    # the hard wall-clock ceiling the request ran under (supervision
    # contract, resilience/supervisor.py); None = no ceiling armed
    hard_ceiling_s: Optional[float] = None
    # per-phase latency breakdown in ms (admission_wait / resolve /
    # compute / gate) — the per-request rows behind serving.latency
    phases: Dict[str, float] = field(default_factory=dict)
    partition: Optional[np.ndarray] = None  # library callers only
    # library callers only, like the partition: the request's peak device
    # bytes on the card, read around it (in its worker where isolated);
    # and a process-isolated request's kernel launches in the worker
    # (its reply's ledger) with, where the caller set _native.EVENT_LOG,
    # their summed CUDA-event ms
    device_peak_bytes: Optional[int] = None
    worker_launches: Dict[str, int] = field(default_factory=dict)
    worker_kernel_ms: Optional[Dict[str, float]] = None

    def to_dict(self) -> dict:
        d = {
            "request_id": self.request_id,
            "verdict": self.verdict,
            "k": int(self.k),
            "n": int(self.n),
            "m": int(self.m),
            "cut": int(self.cut),
            "imbalance": float(self.imbalance),
            "feasible": bool(self.feasible),
            "cached": bool(self.cached),
            "wall_s": round(float(self.wall_s), 4),
        }
        for key in ("reason", "error", "detail", "bucket"):
            v = getattr(self, key)
            if v:
                d[key] = v
        if self.gate_valid is not None:
            d["gate_valid"] = bool(self.gate_valid)
        if self.hard_ceiling_s is not None:
            d["hard_ceiling_s"] = round(float(self.hard_ceiling_s), 3)
        if self.degraded_sites:
            d["degraded_sites"] = list(self.degraded_sites)
        if self.phases:
            d["phases"] = dict(self.phases)
        return d


@dataclass
class ServiceConfig:
    """Admission + cache policy knobs (docs/robustness.md)."""

    max_queue_depth: int = 64
    #: total estimated cost admitted but not yet run, in BYTES of
    #: estimated device footprint (resilience/memory.estimate_run_bytes)
    #: — one sizing model shared by `request-too-large`/`cost-cap` and
    #: the `insufficient-memory` rule
    max_queued_cost: float = float(8 << 30)
    #: a single request estimated larger than this (bytes) is rejected
    #: outright
    max_request_cost: float = float(4 << 30)
    result_cache_entries: int = 128
    result_cache_bytes: int = 256 << 20
    #: default per-request budget when the request carries none (0: none)
    default_deadline_s: float = 0.0
    #: consecutive crash-shaped failures before a request class is
    #: rejected at admission (mirrors the site breaker threshold)
    breaker_threshold: int = BREAKER_THRESHOLD
    #: keep partitions on the records (library callers; the CLI drops
    #: them — a 16-request batch of 1M-node graphs is 64 MB of labels)
    keep_partitions: bool = False
    #: execution isolation (docs/robustness.md, supervision contract):
    #: "inproc" (default) runs compute on the caller's thread exactly
    #: as before; "process" runs it in a supervised worker subprocess
    #: — a worker hang is SIGKILLed past the hard ceiling (verdict
    #: `failed`/`worker-hang`), a worker death is classified
    #: (`worker-crash`), and the service keeps draining either way
    isolation: str = "inproc"
    #: explicit per-request hard wall-clock ceiling in seconds (0 =
    #: derive from the cooperative deadline via hard_deadline_factor,
    #: or KAMINPAR_TPU_HARD_DEADLINE_S)
    hard_deadline_s: float = 0.0
    #: hard ceiling = max(factor * budget, budget + grace) for requests
    #: that carry a cooperative deadline (resilience/supervisor.py)
    hard_deadline_factor: float = 10.0
    #: recycle the warm worker after this many requests (leak
    #: containment; process isolation only)
    worker_max_requests: int = 32
    #: ... or once its peak RSS exceeds this watermark (bytes; 0 = off)
    worker_rss_limit_bytes: float = float(4 << 30)
    #: liveness heartbeat file (also settable via --heartbeat-file /
    #: KAMINPAR_TPU_HEARTBEAT_FILE); "" = disabled
    heartbeat_file: str = ""
    #: live metrics export file (Prometheus text format, rewritten
    #: atomically on a cadence; also settable via --metrics-file /
    #: KAMINPAR_TPU_METRICS_FILE); "" = disabled — the registry stays
    #: dormant and costs one attribute read per producer call
    metrics_file: str = ""


class PartitionService:
    """Admission-controlled, fault-isolated partitioning service."""

    def __init__(self, ctx: Any = "default",
                 config: Optional[ServiceConfig] = None,
                 quiet: bool = True, device: Any = "cuda") -> None:
        from ..context import Context
        from ..device import resolve_device
        from ..presets import create_context_by_preset_name

        if isinstance(ctx, str):
            ctx = create_context_by_preset_name(ctx)
        assert isinstance(ctx, Context)
        self.base_ctx = ctx
        # every request runs here, a worker's too; raises without a card
        # when the card is asked for
        self.device = resolve_device(device)
        self.config = config or ServiceConfig()
        self.quiet = quiet
        # guards the queue/bookkeeping maps so concurrent submit()
        # producers are safe; execution itself stays serial and unlocked
        self._lock = threading.Lock()
        self._queue: List[PartitionRequest] = []
        self._queued_cost: Dict[str, float] = {}
        self._records: List[RequestRecord] = []
        self._seq = itertools.count()
        self._order: Dict[str, int] = {}  # request_id -> FIFO tiebreak
        self._submit_class: Dict[str, str] = {}  # id -> admission class
        self._admission_rejected = 0  # excludes drain-time rejections
        self._result_cache = caching.BoundedCache(
            max_entries=self.config.result_cache_entries,
            max_bytes=self.config.result_cache_bytes,
        )
        # the memory governor sheds this cache first under HBM pressure
        # (resilience/memory.shed_caches; weakly held — dies with us)
        from ..resilience import memory as _memory_mod

        _memory_mod.register_shed_target(self._result_cache)
        self._buckets = caching.BucketTracker()
        # per-request-class (executable bucket) crash counters
        self._class_failures: Dict[str, int] = {}
        # dynamic graph sessions (dynamic/): id -> live
        # GraphSession, plus the decision rows for the report's
        # `dynamic` section.  Session requests run inproc only — the
        # supervised worker exchange ships graphs by value and cannot
        # carry mutable session state (documented; admission rejects
        # with `session-isolation` under process isolation).
        self._sessions: Dict[str, Any] = {}
        self._dynamic_decisions: List[dict] = []
        self._drained = False
        # serving latency metrics (telemetry/perf.py Histogram): one
        # streaming histogram per request phase plus a per-class (bucket)
        # rollup — the report's serving.latency section.  Windowed with
        # the records (reset_records), so a long-lived service reports
        # per-window percentiles instead of frozen lifetime averages.
        from ..telemetry.perf import Histogram

        self._latency: Dict[str, Histogram] = {
            phase: Histogram()
            for phase in ("admission_wait", "resolve", "compute",
                          "gate", "total")
        }
        self._class_latency: Dict[str, Histogram] = {}
        self._submit_t: Dict[str, float] = {}  # id -> submit stamp
        # supervised execution (resilience/supervisor.py): in process
        # mode compute runs in a warm worker subprocess under the hard
        # wall-clock watchdog — spawned lazily on the first executed
        # request, recycled on the configured request/RSS watermarks
        from ..resilience import supervisor as supervisor_mod

        if self.config.isolation not in ("inproc", "process"):
            raise ValueError(
                f"unknown isolation mode {self.config.isolation!r} "
                "(want 'inproc' or 'process')"
            )
        self._pool = (
            supervisor_mod.WorkerPool(
                max_requests=int(self.config.worker_max_requests),
                rss_limit_bytes=int(self.config.worker_rss_limit_bytes),
                device=self.device,
            )
            if self.config.isolation == "process" else None
        )
        if self.config.heartbeat_file:
            supervisor_mod.set_heartbeat(self.config.heartbeat_file)
        # live metrics export (telemetry/metrics.py): dormant unless a
        # file is configured here or via KAMINPAR_TPU_METRICS_FILE —
        # configure() resolves arg-then-env and is a no-op otherwise
        from ..telemetry import metrics as metrics_mod

        metrics_mod.configure(self.config.metrics_file or None)
        # throughput accounting for summary()["throughput"] and the
        # SERVING stdout line — service-local (NOT the live registry),
        # so it works with metrics export dormant
        self._rate = metrics_mod.WindowRate(
            "serving_rps", "service-local throughput window")
        self._queue_peak = 0
        self._occupancy_sum = 0.0
        self._occupancy_n = 0
        # per-request trace ids (telemetry/tracing.py): created at
        # admission when tracing is active, popped when the verdict's
        # phase spans are recorded
        self._trace_ids: Dict[str, str] = {}

    # -- admission -----------------------------------------------------

    def _estimate(self, req: PartitionRequest):
        """(cost, n, m) for admission — cost is the ESTIMATED DEVICE
        BYTES of the request (resilience/memory.estimate_run_bytes for
        the padded bucket), the same sizing model the memory budget is
        enforced in; n/m are -1 when unknown without loading the input
        (opaque file path — sized from the file length, never a load)."""
        k = int(req.k or 2)

        def price(n: int, m: int) -> float:
            # governor pricing at admission: external-scheme services
            # cost the STREAM state (O(n) vectors + chunk buffers +
            # the coarse handoff target), everything else the padded
            # in-core bucket — one sizing model per scheme, shared
            # with the insufficient-memory rule below
            from ..context import PartitioningMode
            from ..resilience import memory as memory_mod

            if self.base_ctx.partitioning.mode == PartitioningMode.EXTERNAL:
                ext = self.base_ctx.external
                return float(memory_mod.estimate_stream_bytes(
                    n, int(ext.chunk_edges), k
                ))
            return float(memory_mod.estimate_run_bytes(n, m, k))

        kind = getattr(req, "kind", "partition")
        if kind in ("mutate", "repartition"):
            # session kinds are sized from the LIVE session graph (the
            # one state admission can know without loading anything); a
            # mutate is host-side CSR work — priced nominally so the
            # cost cap still counts it
            sess = self._sessions.get(req.session or "")
            if sess is None:
                return DEFAULT_COST, -1, -1
            n, m = int(sess.graph.n), int(sess.graph.m)
            if kind == "mutate":
                return float(1 << 20), n, m
            return price(n, m), n, m
        g = req.graph
        if hasattr(g, "n") and hasattr(g, "m"):
            n, m = int(g.n), int(g.m)
            return price(n, m), n, m
        if isinstance(g, str) and g.startswith("gen:"):
            try:
                from ..graphs.factories import parse_gen_spec

                _, kw = parse_gen_spec(g)
                n = int(kw.get("n") or (
                    int(kw.get("x", 1)) * int(kw.get("y", 1))
                    * int(kw.get("z", 1))
                ))
                m = int(kw.get("m") or n * float(kw.get("avg_degree", 8)))
                return price(n, m), n, m
            except Exception:
                return DEFAULT_COST, -1, -1
        if isinstance(g, str):
            try:
                import os

                return (
                    max(float(os.path.getsize(g)) * FILE_COST_FACTOR, 1.0),
                    -1, -1,
                )
            except OSError:
                return DEFAULT_COST, -1, -1
        return DEFAULT_COST, -1, -1

    def _class_key(self, n: int, m: int, k: int) -> str:
        if n < 0:
            return "unsized"
        return "/".join(str(x) for x in caching.bucket_key(n, m, k))

    def _admission_reason(self, req: PartitionRequest, cost: float,
                          cls: str, n: int = -1, m: int = -1) -> str:
        """First violated admission rule, or "" to admit.  The injected
        `serving-admit` fault routes through the policy wrapper so the
        chaos suite sees the standard `degraded` event."""
        admitted = with_fallback(
            lambda: True, lambda exc: False,
            site="serving-admit", where=req.request_id,
        )
        if not admitted:
            return "fault-injected"
        if deadline_mod.draining():
            return "draining"
        kind = getattr(req, "kind", "partition")
        if kind not in ("partition", "register", "mutate", "repartition"):
            return "invalid-parameters"
        if kind != "partition":
            if self._pool is not None:
                # the worker exchange ships graphs by value; mutable
                # session state cannot round-trip it (docs/robustness.md
                # "Dynamic sessions") — refuse structurally instead of
                # silently running outside the supervision boundary
                return "session-isolation"
            if not req.session:
                return "invalid-parameters"
            if kind == "register" and req.session in self._sessions:
                return "duplicate-session"
            if kind in ("mutate", "repartition") \
                    and req.session not in self._sessions:
                return "unknown-session"
            if kind == "mutate" and not isinstance(req.delta, dict):
                return "invalid-parameters"
        if kind in ("partition", "register") and (
            req.k is None or int(req.k) < 1
        ):
            return "invalid-parameters"
        if req.request_id in self._queued_cost:
            # a pending duplicate would corrupt the cost/FIFO maps keyed
            # by request_id; completed ids may be reused (re-submission)
            return "duplicate-id"
        if len(self._queue) >= self.config.max_queue_depth:
            return "queue-full"
        if cost > self.config.max_request_cost:
            return "request-too-large"
        if sum(self._queued_cost.values()) + cost > self.config.max_queued_cost:
            return "cost-cap"
        # memory-budget admission (resilience/memory.py): a request
        # whose MINIMUM device-resident footprint (the rung-2
        # spilled-hierarchy estimate) exceeds the declared budget could
        # only ever be served at the streamed/host rungs — orders slower
        # than the service's latency contract — so it is rejected with a
        # structured verdict instead.  Sized without loading the graph;
        # unsized (file-backed) inputs skip the rule, consistent with
        # the 'unsized' breaker-class convention.  Single-shot CLI runs
        # still degrade through every rung.
        if n >= 0:
            from ..context import PartitioningMode
            from ..resilience import memory as memory_mod

            budget = memory_mod.budget_bytes(self.base_ctx)
            if budget and memory_mod.governor_enabled():
                # external-scheme services price the STREAM, not the
                # resident hierarchy — that pricing asymmetry is the
                # scheme's whole point: a graph far over the in-core
                # budget is admissible as long as the O(n) vectors +
                # one floor chunk fit (external/)
                if (
                    self.base_ctx.partitioning.mode
                    == PartitioningMode.EXTERNAL
                ):
                    floor = memory_mod.min_streamable_bytes(
                        n, int(req.k or 2)
                    )
                else:
                    floor = memory_mod.min_serveable_bytes(
                        n, m, int(req.k or 2)
                    )
                if floor > budget:
                    return "insufficient-memory"
        if self._class_failures.get(cls, 0) >= self.config.breaker_threshold:
            return "breaker-open"
        return ""

    def submit(self, req: PartitionRequest) -> Optional[RequestRecord]:
        """Admission-check one request.  Returns the ``rejected`` record
        when the request is refused (already appended to the batch
        records); None when it was queued."""
        cost, n, m = self._estimate(req)
        cls = self._class_key(n, m, int(req.k or 0))
        with self._lock:
            reason = self._admission_reason(req, cost, cls, n, m)
            if reason:
                rec = RequestRecord(
                    request_id=req.request_id, verdict="rejected",
                    reason=reason, k=int(req.k or 0), n=n, m=m,
                )
                self._records.append(rec)
                self._admission_rejected += 1
                depth = len(self._queue)
            else:
                self._queue.append(req)
                self._queued_cost[req.request_id] = cost
                self._order[req.request_id] = next(self._seq)
                self._submit_class[req.request_id] = cls
                self._submit_t[req.request_id] = time.perf_counter()
                depth = len(self._queue)
                self._queue_peak = max(self._queue_peak, depth)
                rec = None
        from ..telemetry import metrics as metrics_mod
        from ..telemetry import tracing

        if metrics_mod.enabled():
            metrics_mod.set_gauge(
                "kmp_queue_depth", depth,
                "Requests admitted but not yet executed.")
            metrics_mod.set_gauge(
                "kmp_queue_peak", self._queue_peak,
                "Peak queue depth observed this process.")
        if rec is not None:
            telemetry.event(
                "serving", action="rejected", request=req.request_id,
                reason=reason, queue_depth=depth,
            )
            if metrics_mod.enabled():
                metrics_mod.inc(
                    "kmp_requests_total",
                    "Requests by final verdict.", 1.0,
                    verdict="rejected")
        else:
            tid = tracing.new_trace(
                req.request_id, k=int(req.k or 0),
                kind=getattr(req, "kind", "partition"),
            )
            if tid:
                self._trace_ids[req.request_id] = tid
                tracing.span(
                    tid, "admission", duration_s=0.0,
                    cls=cls, queue_depth=depth,
                )
        return rec

    # -- execution -----------------------------------------------------

    def run_pending(self) -> List[RequestRecord]:
        """Execute the queue serially (priority desc, then FIFO).  A
        drain signal observed between requests rejects the remainder;
        the batch always returns one record per request."""
        done: List[RequestRecord] = []
        while True:
            with self._lock:
                if not self._queue:
                    break
                self._queue.sort(
                    key=lambda r: (-r.priority, self._order[r.request_id])
                )
                req = self._queue.pop(0)
                self._queued_cost.pop(req.request_id, None)
                self._order.pop(req.request_id, None)
                cls_submit = self._submit_class.pop(req.request_id, "")
                submit_t = self._submit_t.pop(req.request_id, None)
            if deadline_mod.draining():
                self._drained = True
                rec = RequestRecord(
                    request_id=req.request_id, verdict="rejected",
                    reason="draining", k=int(req.k or 0),
                )
            else:
                wait_s = (
                    time.perf_counter() - submit_t
                    if submit_t is not None else 0.0
                )
                # deep layers (dist rank rollup, dynamic session
                # commits) attach their spans to the current trace
                from ..telemetry import tracing

                tracing.set_current(
                    self._trace_ids.get(req.request_id, "")
                )
                try:
                    rec = self._execute(req, cls_submit, wait_s)
                finally:
                    tracing.set_current("")
            with self._lock:
                self._records.append(rec)
            done.append(rec)
            self._request_done(rec)
        return done

    def _request_done(self, rec: RequestRecord) -> None:
        """Per-verdict bookkeeping after one EXECUTED request (drain
        rejections included; admission rejections are counted at
        submit): throughput window, batch occupancy, the live metrics
        registry, and the trace verdict annotation."""
        from ..telemetry import metrics as metrics_mod
        from ..telemetry import tracing

        self._rate.mark()
        occ = None
        if rec.bucket and rec.n >= 0:
            try:
                # bucket_key pads n+1 node slots; occupancy is how much
                # of the padded executable this request actually filled
                n_pad = int(rec.bucket.split("/")[0])
                occ = min(1.0, float(rec.n + 1) / float(n_pad))
            except (ValueError, ZeroDivisionError):
                occ = None
            if occ is not None:
                self._occupancy_sum += occ
                self._occupancy_n += 1
        tid = self._trace_ids.pop(rec.request_id, "")
        if tid:
            tracing.annotate(
                tid, verdict=rec.verdict,
                **({"reason": rec.reason} if rec.reason else {}),
            )
        if not metrics_mod.enabled():
            return
        metrics_mod.inc(
            "kmp_requests_total", "Requests by final verdict.", 1.0,
            verdict=rec.verdict)
        metrics_mod.mark(
            "kmp_requests_per_second",
            "Requests completed, per second over a sliding window.")
        with self._lock:
            depth = len(self._queue)
        metrics_mod.set_gauge(
            "kmp_queue_depth", depth,
            "Requests admitted but not yet executed.")
        if self._occupancy_n:
            metrics_mod.set_gauge(
                "kmp_batch_occupancy",
                round(self._occupancy_sum / self._occupancy_n, 4),
                "Mean padded-executable fill fraction of executed "
                "requests.")
        metrics_mod.set_gauge(
            "kmp_cache_hit_rate",
            float(self._result_cache.stats()["hit_rate"]),
            "Result-cache hit rate (lifetime).")
        metrics_mod.set_gauge(
            "kmp_breaker_open_classes",
            sum(1 for v in self._class_failures.values()
                if v >= self.config.breaker_threshold),
            "Request classes currently rejected by the crash breaker.")
        if self._pool is not None:
            for event, v in self._pool.stats.items():
                metrics_mod.set_gauge(
                    "kmp_worker_pool", float(v),
                    "Worker-pool lifecycle counters "
                    "(spawned/recycled/killed/crashed/requests).",
                    event=str(event))
        from ..resilience import runstate as runstate_mod

        gov = runstate_mod.current().memory
        if gov is not None:
            metrics_mod.set_gauge(
                "kmp_governor_rung", float(gov.rung),
                "Memory-governor degradation rung of the last run.")
        from ..resilience import supervisor as supervisor_mod

        hb = supervisor_mod.heartbeat_path()
        if hb:
            try:
                import os

                metrics_mod.set_gauge(
                    "kmp_heartbeat_age_seconds",
                    round(max(0.0, time.time() - os.path.getmtime(hb)),
                          3),
                    "Seconds since the liveness heartbeat file "
                    "advanced.")
            except OSError:
                pass

    def serve(self, requests) -> List[RequestRecord]:
        """Drive a whole batch: submit() each request, draining the
        queue whenever the next submission would trip the queue-depth or
        aggregate-cost cap — a batch is ONE producer, so backpressure
        means "run what is queued first", not "reject the tail" (the
        caps still reject outright for concurrent submit() producers and
        for single oversized requests).  Returns this batch's records
        (admission rejections included, in order)."""
        start = len(self._records)
        for req in requests:
            # session-kind requests depend on earlier requests having
            # EXECUTED (a mutate needs its register/mutate predecessors
            # committed, and priority sorting must not reorder a
            # session's chain) — drain the queue before admitting one
            if self._queue and (
                self._would_overflow(req)
                or getattr(req, "kind", "partition") != "partition"
            ):
                self.run_pending()
            self.submit(req)
        self.run_pending()
        return self._records[start:]

    def _would_overflow(self, req: PartitionRequest) -> bool:
        cost, _, _ = self._estimate(req)
        with self._lock:
            return (
                len(self._queue) >= self.config.max_queue_depth
                or sum(self._queued_cost.values()) + cost
                > self.config.max_queued_cost
            )

    def _resolve_graph(self, source):
        """Load/generate the input INSIDE the isolation boundary."""
        if isinstance(source, str):
            if source.startswith("gen:"):
                from ..graphs.factories import generate

                return generate(source)
            from .. import io as io_mod

            return io_mod.load_graph(source)
        if not (hasattr(source, "n") and hasattr(source, "m")):
            raise res_errors.AdmissionRejected(
                f"request graph is neither a graph object nor a "
                f"path/spec string: {type(source).__name__}"
            )
        return source

    def _request_ctx(self, req: PartitionRequest):
        """Per-request context: the base tree deep-copied, resilience
        re-scoped to this request (no cross-request checkpoint state;
        the per-request deadline arms the anytime budget)."""
        ctx = self.base_ctx.copy()
        ctx.resilience.checkpoint_dir = ""
        ctx.resilience.resume = False
        budget = (
            req.deadline_s if req.deadline_s is not None
            else self.config.default_deadline_s
        )
        ctx.resilience.time_budget = float(budget or 0.0)
        if req.seed is not None:
            ctx.seed = int(req.seed)
        # stamp the partition target so the ctx fingerprint (and with it
        # the result-cache key) covers (k, eps) before setup runs
        ctx.partition.k = int(req.k)
        if req.epsilon is not None:  # None = keep the ctx default
            ctx.partition.epsilon = float(req.epsilon)
        return ctx

    def _hard_ceiling(self, req: PartitionRequest) -> Optional[float]:
        """The request's hard wall-clock ceiling (supervision contract):
        explicit service override first, else derived from the
        cooperative per-request deadline (or the env override) via
        resilience/supervisor.hard_ceiling.  None = no ceiling."""
        from ..resilience import supervisor as supervisor_mod

        if req.hard_deadline_s is not None and req.hard_deadline_s > 0:
            return float(req.hard_deadline_s)
        if self.config.hard_deadline_s > 0:
            return float(self.config.hard_deadline_s)
        budget = (
            req.deadline_s if req.deadline_s is not None
            else self.config.default_deadline_s
        )
        return supervisor_mod.hard_ceiling(
            budget or 0.0, factor=self.config.hard_deadline_factor
        )

    def _cache_lookup(self, key, req: PartitionRequest,
                      pre_degraded: List[str]):
        """Result-cache get through the `serving-cache` site: an
        injected fault forces a miss AND evicts the key (both documented
        degradation modes at once — deterministic for the chaos suite).
        The engaged site is recorded in ``pre_degraded`` because the
        facade resets the telemetry stream at compute entry — the event
        emitted here would otherwise vanish before the verdict is cut.
        """
        def forced_miss(exc):
            self._result_cache.evict(key)
            pre_degraded.append("serving-cache")
            return None

        cached = with_fallback(
            lambda: self._result_cache.get(key), forced_miss,
            site="serving-cache", where=req.request_id,
        )
        if cached is None:
            return None
        from ..resilience import integrity
        from ..resilience.errors import IntegrityViolation

        # entries written before the digest upgrade verify vacuously
        if len(cached) == 3:
            part, metrics, digest = cached
        else:
            part, metrics = cached
            digest = ""
        # `cache-poison` chaos flips a bit of the array ABOUT to be
        # served; the stored content digest is what catches it.  A
        # poisoned entry must read as a forced miss + evict — served
        # stale bytes are the one cache failure mode worse than a miss.
        part = integrity.chaos_flip_array("cache-poison", part)
        try:
            integrity.verify_digest(
                digest, part,
                what=f"result-cache:{req.request_id}",
                site="cache-poison",
            )
        except IntegrityViolation:
            self._result_cache.evict(key)
            pre_degraded.append("cache-poison")
            from ..utils.logger import log_warning

            log_warning(
                f"serving[{req.request_id}]: result-cache entry failed "
                "digest verification; evicted, recomputing"
            )
            return None
        return part, metrics

    def _note_failure(self, rec: RequestRecord, exc: BaseException,
                      cls: str, cls_submit: str) -> None:
        """THE failure bookkeeping of the isolation boundary — shared
        by the stateless (:meth:`_execute`) and session-kind
        (:meth:`_execute_session`) paths so the verdict/reason
        taxonomy, the breaker exemptions, and the telemetry surface
        can never drift apart: classify, stamp the reason
        (worker-crash / worker-hang|stage-hang / malformed-input /
        exception), advance the per-class breaker for crash-shaped
        failures only."""
        err = res_errors.classify(exc, site="")
        rec.verdict = "failed"
        rec.error = type(err if err is not None else exc).__name__
        rec.detail = str(exc)[:300]
        # supervision verdicts (resilience/supervisor.py) carry their
        # own reason taxonomy: a SIGKILLed hung worker reads
        # `worker-hang`, a dead worker `worker-crash`, and an
        # in-process watchdog overrun `stage-hang` — everything else
        # keeps the malformed-input/exception split.  (err.site is NOT
        # trusted for hangs: a hang landing inside a guarded primary
        # may carry that site's stamp.)
        if isinstance(err, res_errors.WorkerCrash):
            rec.reason = "worker-crash"
        elif isinstance(err, res_errors.StageHang):
            rec.reason = (
                "worker-hang" if self._pool is not None
                else "stage-hang"
            )
        elif isinstance(err, res_errors.IntegrityViolation):
            # detected silent data corruption that exhausted the
            # retry-from-barrier ladder (or a corrupted worker reply):
            # its own taxonomy row — NOT malformed-input, the input was
            # fine; the bytes rotted in compute or exchange
            rec.reason = "corrupt-result"
        else:
            rec.reason = (
                "malformed-input" if _input_shaped(exc)
                else "exception"
            )
        # crash-shaped failures advance the request-class breaker;
        # refusal-shaped degradations (breaker_relevant=False) and
        # malformed inputs do not — a bad file/delta says nothing about
        # the next request of the same shape.  Latched under BOTH the
        # resolved executable bucket and the admission-time estimate
        # class (for file-backed inputs those differ), so the admission
        # check actually observes the count.
        crash = (
            err.breaker_relevant if err is not None
            else not _input_shaped(exc)
        )
        if (
            isinstance(err, res_errors.DeviceOOM)
            and not err.rungs_exhausted
        ):
            # a ladder-retryable OOM indicts the budget, not the
            # request class — only rung EXHAUSTION is crash-shaped
            crash = False
        if crash:
            for c in {cls, cls_submit} - {""}:
                self._class_failures[c] = (
                    self._class_failures.get(c, 0) + 1
                )
        telemetry.event(
            "serving", action="failed", request=rec.request_id,
            error=rec.error, reason=rec.reason,
        )
        from ..utils.logger import log_warning

        log_warning(
            f"serving[{rec.request_id}]: request failed in isolation "
            f"({rec.error}: {rec.detail[:120]}); service continues"
        )

    def _execute_session(self, req: PartitionRequest,
                         cls_submit: str = "",
                         wait_s: float = 0.0) -> RequestRecord:
        """The session-scoped request kinds (register / mutate /
        repartition, dynamic/) under the same isolation
        boundary, breaker, and latency accounting as stateless
        requests.  Sessions are created only on a fully successful
        register; a failed mutate leaves the session at its pre-delta
        state (the CSR patch is computed pure before either commit
        path)."""
        from ..resilience.checkpoint import SimulatedPreemption
        from ..utils.logger import OutputLevel

        t0 = time.perf_counter()
        rec = RequestRecord(
            request_id=req.request_id, verdict="failed",
            k=int(req.k or 0),
        )
        cls = cls_submit or "unsized"
        resolve_s = compute_s = 0.0
        try:
            if req.kind == "register":
                from ..dynamic import GraphSession
                from ..kaminpar import KaMinPar

                graph = self._resolve_graph(req.graph)
                resolve_s = time.perf_counter() - t0
                sess = GraphSession(
                    req.session, graph, k=int(req.k))
                rec.n, rec.m = int(graph.n), int(graph.m)
                bucket = self._buckets.observe(rec.n, rec.m, int(req.k))
                rec.bucket = "/".join(str(x) for x in bucket)
                cls = self._class_key(rec.n, rec.m, int(req.k))
                rec.hard_ceiling_s = self._hard_ceiling(req)
                ctx = self._request_ctx(req)
                solver = KaMinPar(ctx, device=self.device)
                if self.quiet:
                    solver.set_output_level(OutputLevel.QUIET)
                solver.set_graph(sess.graph)
                # the session REMEMBERS its balance contract: later
                # repartitions without an explicit epsilon reuse it
                sess.epsilon = (
                    float(req.epsilon) if req.epsilon is not None
                    else None
                )
                t_c0 = time.perf_counter()
                part = solver.compute_partition(
                    k=int(req.k), epsilon=req.epsilon,
                    seed=req.seed,
                )
                compute_s = time.perf_counter() - t_c0
                metrics = solver.result_metrics(sess.graph, part)
                rec.gate_valid = telemetry.gate_verdict()
                sess.commit_partition(
                    part, int(metrics["cut"]),
                    gate_valid=rec.gate_valid)
                self._sessions[req.session] = sess
                rec.cut = int(metrics["cut"])
                rec.imbalance = float(metrics["imbalance"])
                rec.feasible = bool(metrics["feasible"])
                rec.degraded_sites = sorted({
                    e.attrs.get("site", "")
                    for e in telemetry.events("degraded")
                } - {""})
                anytime = solver.last_anytime
                self._dynamic_decisions.append({
                    "session": sess.id, "kind": "register",
                    "mode": "cold", "drift": None, "cut_before": None,
                    "cut": rec.cut, "feasible": rec.feasible,
                    "stable": None, "escalated": False, "seeded": 0,
                    "wall_s": round(compute_s, 4),
                    "warm_wall_s": None,
                    "cold_wall_s": round(compute_s, 4),
                    **({"gate_valid": rec.gate_valid}
                       if rec.gate_valid is not None else {}),
                })
            elif req.kind == "mutate":
                from ..dynamic import DeltaBatch

                sess = self._sessions[req.session]
                batch = DeltaBatch.from_dict(req.delta)
                resolve_s = time.perf_counter() - t0
                # mutate runs no compute, so the telemetry stream is
                # NOT reset for this request — snapshot the degraded
                # count so a previous request's degradations are not
                # attributed to this one
                deg_before = len(telemetry.events("degraded"))
                t_c0 = time.perf_counter()
                info = sess.apply(batch)
                compute_s = time.perf_counter() - t_c0
                rec.degraded_sites = sorted({
                    e.attrs.get("site", "")
                    for e in telemetry.events("degraded")[deg_before:]
                } - {""})
                rec.k = int(sess.k)
                rec.n, rec.m = info["n"], info["m"]
                rec.bucket = info["bucket"]
                cls = self._class_key(rec.n, rec.m, int(sess.k))
                rec.reason = (
                    "in-place" if info["in_place"] else "rebuild")
                anytime = None
                rec.cut = (
                    -1 if sess.last_cut is None else int(sess.last_cut))
                rec.feasible = sess.last_cut is not None
            else:  # repartition
                from ..dynamic import repartition as _repartition

                sess = self._sessions[req.session]
                resolve_s = time.perf_counter() - t0
                k = int(req.k or sess.k)
                rec.k = k
                rec.n, rec.m = int(sess.graph.n), int(sess.graph.m)
                bucket = self._buckets.observe(rec.n, rec.m, k)
                rec.bucket = "/".join(str(x) for x in bucket)
                cls = self._class_key(rec.n, rec.m, k)
                rec.hard_ceiling_s = self._hard_ceiling(req)
                ctx = self._request_ctx(req)
                ctx.partition.k = k  # req.k may be 0 = "the session's k"
                # epsilon defaults to the SESSION's contract (set at
                # register), not the wire default — caps and the diff
                # gate must match what the session was partitioned under
                eps = (
                    req.epsilon if req.epsilon is not None
                    else sess.epsilon
                )
                t_c0 = time.perf_counter()
                outcome = _repartition(
                    sess, ctx, k=k, epsilon=eps,
                    seed=req.seed, quiet=self.quiet, device=self.device,
                )
                compute_s = time.perf_counter() - t_c0
                rec.cut = int(outcome.cut)
                rec.imbalance = float(outcome.imbalance)
                rec.feasible = bool(outcome.feasible)
                rec.gate_valid = outcome.gate_valid
                rec.degraded_sites = list(outcome.degraded_sites)
                anytime = outcome.anytime
                self._dynamic_decisions.append({
                    **outcome.to_row(sess.id), "kind": "repartition",
                })
        except (KeyboardInterrupt, SystemExit, SimulatedPreemption):
            raise  # process-fatal by contract; never a request verdict
        except BaseException as exc:  # the isolation boundary
            self._note_failure(rec, exc, cls, cls_submit)
            rec.wall_s = time.perf_counter() - t0
            self._observe_latency(
                rec, wait_s, resolve_s,
                max(rec.wall_s - resolve_s, 0.0), 0.0,
            )
            return rec

        for c in {cls, cls_submit} - {""}:
            self._class_failures.pop(c, None)
        if anytime:
            rec.verdict = "anytime"
            if not rec.reason:
                rec.reason = str(anytime.get("reason") or "")
            if rec.reason in ("sigterm", "sigint", "draining"):
                self._drained = True
        elif rec.degraded_sites:
            rec.verdict = "degraded"
        else:
            rec.verdict = "served"
        rec.wall_s = time.perf_counter() - t0
        self._observe_latency(rec, wait_s, resolve_s, compute_s, 0.0)
        # the trace CARRIES the session identity: every register /
        # mutate / repartition against one GraphSession is findable by
        # its session attr (and repartition traces say warm vs cold)
        from ..telemetry import tracing

        tid = self._trace_ids.get(req.request_id, "")
        if tid:
            extra = {}
            if req.kind == "repartition" and self._dynamic_decisions:
                extra["mode"] = self._dynamic_decisions[-1].get("mode")
            tracing.annotate(
                tid, session=req.session, session_kind=req.kind,
                **extra,
            )
        telemetry.event(
            "dynamic", action=req.kind, request=req.request_id,
            session=req.session, verdict=rec.verdict,
        )
        return rec

    def _execute(self, req: PartitionRequest,
                 cls_submit: str = "",
                 wait_s: float = 0.0) -> RequestRecord:
        from ..kaminpar import KaMinPar
        from ..resilience.checkpoint import SimulatedPreemption
        from ..utils import timer
        from ..utils.logger import OutputLevel

        if getattr(req, "kind", "partition") != "partition":
            return self._execute_session(req, cls_submit, wait_s)

        t0 = time.perf_counter()
        rec = RequestRecord(
            request_id=req.request_id, verdict="failed", k=int(req.k),
        )
        cls = cls_submit or "unsized"
        pre_degraded: List[str] = []
        resolve_s = compute_s = gate_s = 0.0
        try:
            graph = self._resolve_graph(req.graph)
            resolve_s = time.perf_counter() - t0
            rec.n, rec.m = int(graph.n), int(graph.m)
            ctx = self._request_ctx(req)
            key = caching.result_cache_key(graph, ctx)
            cached = self._cache_lookup(key, req, pre_degraded)
            if cached is not None:
                part, metrics = cached
                rec.verdict = "served"
                rec.cached = True
                rec.cut = int(metrics["cut"])
                rec.imbalance = float(metrics["imbalance"])
                rec.feasible = bool(metrics["feasible"])
                rec.gate_valid = metrics.get("gate_valid")
                rec.partition = part if self.config.keep_partitions else None
                rec.wall_s = time.perf_counter() - t0
                self._observe_latency(rec, wait_s, resolve_s, 0.0, 0.0)
                telemetry.event(
                    "serving", action="cache-hit", request=req.request_id,
                )
                return rec
            bucket = self._buckets.observe(rec.n, rec.m, int(req.k))
            rec.bucket = "/".join(str(x) for x in bucket)
            cls = self._class_key(rec.n, rec.m, int(req.k))
            rec.hard_ceiling_s = self._hard_ceiling(req)

            winfo = None
            solver = None
            t_c0 = time.perf_counter()
            if self._pool is not None:
                # supervised worker execution: compute runs in the
                # spawned worker under the hard wall-clock watchdog; a
                # hang is SIGKILLed and surfaces as StageHang (site
                # `worker-hang`), a worker death as WorkerCrash — both
                # land in the isolation boundary below like any other
                # classified failure, and the queue keeps draining
                tid = self._trace_ids.get(req.request_id, "")
                part, winfo = self._pool.run_request(
                    req.request_id, req.graph, graph, ctx,
                    k=int(req.k),
                    epsilon=float(req.epsilon if req.epsilon is not None
                                  else 0.03),
                    seed=req.seed, ceiling_s=rec.hard_ceiling_s,
                    trace=bool(tid),
                )
                gate_s = float(winfo.get("gate_s") or 0.0)
                # the kernel launches the worker made on this request's
                # behalf, across the containment boundary
                rec.worker_launches = {
                    name: int(count)
                    for name, count in (winfo.get("ledger") or {}).items()}
                rec.worker_kernel_ms = winfo.get("kernel_ms")
                if winfo.get("device_peak_bytes"):
                    rec.device_peak_bytes = int(winfo["device_peak_bytes"])
                if tid and winfo.get("trace_spans"):
                    # marshal the worker-side spans into this request's
                    # timeline: the spawn/ship overhead span first, the
                    # worker's own scopes re-based after it
                    from ..telemetry import tracing

                    tracing.record_worker_reply(
                        tid, winfo["trace_spans"], t_c0,
                        time.perf_counter() - t_c0,
                        float(winfo.get("wall_s") or 0.0),
                    )
            else:
                solver = KaMinPar(ctx, device=self.device)
                if self.quiet:
                    solver.set_output_level(OutputLevel.QUIET)
                solver.set_graph(graph)
                on_card = self.device.type == "cuda"
                if on_card:
                    import torch

                    torch.cuda.reset_peak_memory_stats(self.device)
                part = solver.compute_partition(
                    k=int(req.k),
                    epsilon=float(req.epsilon if req.epsilon is not None
                                  else 0.03),
                    seed=req.seed,
                )
                if on_card:
                    rec.device_peak_bytes = int(
                        torch.cuda.max_memory_allocated(self.device))
                # the gate runs inside compute_partition under its own
                # top-level scope; the per-run timer reset at compute
                # entry makes this elapsed figure THIS request's gate
                # time
                gate_s = timer.GLOBAL_TIMER.elapsed("output-gate")
            compute_s = max(time.perf_counter() - t_c0 - gate_s, 0.0)
        except (KeyboardInterrupt, SystemExit, SimulatedPreemption):
            raise  # process-fatal by contract; never a request verdict
        except BaseException as exc:  # the isolation boundary
            self._note_failure(rec, exc, cls, cls_submit)
            rec.wall_s = time.perf_counter() - t0
            # failures carry latency too (whatever phases completed) —
            # a timeout-shaped failure mode must be visible in p99
            self._observe_latency(
                rec, wait_s, resolve_s,
                max(rec.wall_s - resolve_s - gate_s, 0.0), gate_s,
            )
            return rec

        # success path: harvest the per-request telemetry (inproc: the
        # facade reset the stream at compute entry, so everything in it
        # belongs to this request; process: the worker harvested ITS
        # stream the same way and marshalled the harvest back)
        for c in {cls, cls_submit} - {""}:
            self._class_failures.pop(c, None)
        if winfo is not None:
            metrics = dict(winfo["metrics"])
            rec.gate_valid = winfo.get("gate_valid")
            worker_degraded = set(winfo.get("degraded_sites") or [])
            anytime = winfo.get("anytime")
        else:
            metrics = solver.result_metrics(graph, part)
            rec.gate_valid = telemetry.gate_verdict()
            worker_degraded = {
                e.attrs.get("site", "")
                for e in telemetry.events("degraded")
            }
            anytime = solver.last_anytime
        rec.cut = int(metrics["cut"])
        rec.imbalance = float(metrics["imbalance"])
        rec.feasible = bool(metrics["feasible"])
        rec.degraded_sites = sorted(
            (worker_degraded | set(pre_degraded)) - {""}
        )
        if anytime:
            rec.verdict = "anytime"
            rec.reason = str(anytime.get("reason") or "")
            if rec.reason in ("sigterm", "sigint", "draining"):
                self._drained = True
        elif rec.degraded_sites:
            rec.verdict = "degraded"
        else:
            rec.verdict = "served"
        rec.partition = part if self.config.keep_partitions else None
        rec.wall_s = time.perf_counter() - t0
        self._observe_latency(rec, wait_s, resolve_s, compute_s, gate_s)
        if rec.verdict == "served" and rec.feasible:
            # only clean full-effort results are worth replaying; an
            # anytime/degraded answer must not be served to a request
            # that had the time to do better
            from ..resilience import integrity

            part_arr = np.asarray(part)
            # entry digest stamped at put, verified on every hit
            # (resilience/integrity.py exchange contract)
            self._result_cache.put(
                key,
                (part_arr,
                 {**metrics, "gate_valid": rec.gate_valid},
                 integrity.content_digest(part_arr)),
                nbytes=part_arr.nbytes,
            )
        return rec

    def _observe_latency(self, rec: RequestRecord, wait_s: float,
                         resolve_s: float, compute_s: float,
                         gate_s: float) -> None:
        """Fold one request's phase walls into the streaming histograms
        (overall per-phase + per-class total) and stamp the per-request
        breakdown onto its record.  `total` includes the admission wait
        — the latency a CALLER observes, not just the execution."""
        from ..telemetry.perf import Histogram

        total_s = rec.wall_s + wait_s
        phases = {
            "admission_wait": wait_s,
            "resolve": resolve_s,
            "compute": compute_s,
            "gate": gate_s,
            "total": total_s,
        }
        for name, v in phases.items():
            self._latency[name].record(v)
        rec.phases = {
            f"{name}_ms": round(v * 1000.0, 3)
            for name, v in phases.items()
        }
        # request-trace phase spans (telemetry/tracing.py): every
        # execution path funnels through here, so the trace timeline
        # covers queue-wait/resolve/compute/gate for all verdicts; the
        # gate phase includes the greedy balance repair (gate.py)
        tid = self._trace_ids.get(rec.request_id, "")
        if tid:
            from ..telemetry import tracing

            t_exec = time.perf_counter() - rec.wall_s
            tracing.span(tid, "queue-wait", start=t_exec - wait_s,
                         duration_s=wait_s)
            tracing.span(tid, "resolve", start=t_exec,
                         duration_s=resolve_s)
            tracing.span(tid, "compute", start=t_exec + resolve_s,
                         duration_s=compute_s)
            tracing.span(tid, "gate", start=t_exec + resolve_s
                         + compute_s, duration_s=gate_s)
        from ..telemetry import metrics as metrics_mod

        if metrics_mod.enabled():
            metrics_mod.observe(
                "kmp_request_latency_seconds", total_s,
                "End-to-end request latency (admission wait included).")
        # cache hits never touch an executable (rec.bucket stays empty)
        # but still belong to their shape class for the rollup
        cls = rec.bucket or self._class_key(rec.n, rec.m, int(rec.k or 0))
        hist = self._class_latency.get(cls)
        if hist is None:
            hist = self._class_latency[cls] = Histogram()
        hist.record(total_s)

    def latency_summary(self) -> dict:
        """The report's ``serving.latency`` section: per-phase
        histograms (p50/p95/p99 over log-spaced buckets) and the
        per-class rollup joined with executable-bucket reuse counts."""
        sightings = self._buckets.per_bucket()
        classes = {}
        for cls, hist in self._class_latency.items():
            snap = hist.snapshot()
            seen = sightings.get(cls, 0)
            classes[cls] = {
                "requests": snap["count"],
                "p50_ms": snap["p50_ms"],
                "p95_ms": snap["p95_ms"],
                "p99_ms": snap["p99_ms"],
                "mean_ms": snap["mean_ms"],
                # how often the class's padded shape bucket recurred
                # (the JAX package's executable-reuse figure)
                "executable_sightings": int(seen),
                "executable_reuse": (
                    round((seen - 1) / seen, 4) if seen else 0.0
                ),
            }
        return {
            "phases": {
                name: hist.snapshot()
                for name, hist in self._latency.items()
            },
            "classes": classes,
        }

    # -- drain / reporting ---------------------------------------------

    def drain(self, reason: str = "draining") -> None:
        """Programmatic drain: queued requests will be rejected with
        ``draining``; an in-flight run winds down at its next barrier
        (the SIGTERM handlers reach the same state process-wide)."""
        deadline_mod.request_stop(reason)

    @property
    def records(self) -> List[RequestRecord]:
        with self._lock:
            return list(self._records)

    def reset_records(self) -> List[RequestRecord]:
        """Detach and return the accumulated verdict records (with the
        admission-rejection counter).  The records list is the report
        surface — every verdict must land in a report — so it is never
        pruned implicitly; a long-lived service exports a report per
        batch window and then resets, which bounds host memory under
        sustained traffic.  Cache/bucket/breaker state is kept, but
        their WINDOW counters and the latency histograms restart with
        the records — each exported window carries its own hit rates
        and percentiles instead of averages frozen by hours of history.
        """
        with self._lock:
            out = self._records
            self._records = []
            self._admission_rejected = 0
            for hist in self._latency.values():
                hist.reset()
            self._class_latency.clear()
        self._result_cache.begin_window()
        self._buckets.begin_window()
        return out

    def result_cache_stats(self) -> dict:
        return self._result_cache.stats()

    def summary(self) -> dict:
        """The run report's ``serving`` section (schema v4)."""
        with self._lock:
            records = list(self._records)
            admission_rejected = self._admission_rejected
        counts = {v: 0 for v in VERDICTS}
        for rec in records:
            counts[rec.verdict] = counts.get(rec.verdict, 0) + 1
        # supervision verdicts surface in the counts next to the five
        # verdict keys — only when nonzero, so `sum(counts over the
        # verdict keys) == len(requests)` stays true for consumers that
        # sum the whole dict on an unsupervised batch
        for reason_key in ("worker-hang", "worker-crash"):
            hit = sum(1 for r in records if r.reason == reason_key)
            if hit:
                counts[reason_key] = hit
        result_stats = self._result_cache.stats()
        return {
            "enabled": True,
            "requests": [r.to_dict() for r in records],
            "counts": counts,
            "admission": {
                "max_queue_depth": self.config.max_queue_depth,
                "max_queued_cost": float(self.config.max_queued_cost),
                "max_request_cost": float(self.config.max_request_cost),
                # drain-time rejections carry the same verdict but never
                # passed admission; this counter is admission's alone
                "rejected": admission_rejected,
            },
            "cache": {
                "result": result_stats,
                "executable": self._buckets.stats(),
                "hit_rate": result_stats["hit_rate"],
            },
            "latency": self.latency_summary(),
            "throughput": self.throughput_summary(),
            "drained": bool(self._drained),
        }

    def throughput_summary(self) -> dict:
        """Live throughput figures (the SERVING stdout line and the
        bench harness read these): sliding-window requests/second, the
        peak queue depth this process observed, and the mean padded-
        executable fill fraction (None until a sized request ran)."""
        return {
            "requests_per_second": round(float(self._rate.rate()), 3),
            "queue_peak": int(self._queue_peak),
            "batch_occupancy": (
                round(self._occupancy_sum / self._occupancy_n, 4)
                if self._occupancy_n else None
            ),
        }

    def dynamic_summary(self) -> dict:
        """The run report's ``dynamic`` section (schema v11) for this
        service: live session rows + the decision log
        (dynamic/driver.summarize; {'enabled': False}
        when no session request ever ran)."""
        from ..dynamic import summarize

        with self._lock:
            sessions = list(self._sessions.values())
            decisions = list(self._dynamic_decisions)
        return summarize(sessions, decisions)

    def supervision_summary(self) -> dict:
        """The run report's ``supervision`` section (schema v10) for
        this service: worker-pool lifecycle counters, the hang log,
        heartbeat state, watchdog stats, and the isolation mode."""
        from ..resilience import supervisor as supervisor_mod

        return supervisor_mod.summary(
            pool=self._pool, isolation=self.config.isolation
        )

    def close(self) -> None:
        """Shut down the supervised worker pool (process isolation);
        a plain inproc service has nothing to release.  Idempotent.
        Flushes a final metrics scrape so a scraper never misses the
        tail of a short-lived service."""
        if self._pool is not None:
            self._pool.shutdown()
        from ..telemetry import metrics as metrics_mod

        if metrics_mod.enabled():
            metrics_mod.write_now()

    def annotate(self) -> dict:
        """Stamp the serving + supervision sections into the telemetry
        run info (call AFTER the last request — compute_partition
        resets the stream at entry) and return the serving section."""
        s = self.summary()
        telemetry.annotate(
            serving=s, supervision=self.supervision_summary(),
            dynamic=self.dynamic_summary(),
        )
        return s


def _input_shaped(exc: BaseException) -> bool:
    """Failures that indict the request's INPUT, not the process or the
    request class: format errors, missing files, bad parameters."""
    from ..io.errors import GraphFormatError

    return isinstance(
        exc, (GraphFormatError, ValueError, OSError, KeyError, TypeError)
    ) and not isinstance(exc, res_errors.DegradationError)
