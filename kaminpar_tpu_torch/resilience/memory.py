"""The memory governor: the peak-bytes estimator, the declared budget, the
OOM recovery ladder and the host-spilled hierarchy (own copy of
kaminpar_tpu/resilience/memory.py, less its distributed ladder).

A run either fits its declared budget (``ctx.resilience.memory_budget``,
else ``KAMINPAR_TPU_HBM_BYTES``) or degrades through a deterministic
ladder; it does not die with a CUDA out-of-memory error:

  ====  =========================================================
  rung  behavior
  ====  =========================================================
  0     normal run (power-of-two shape buckets, resident hierarchy)
  1     tight padding buckets (``caching.pad_policy_scope("tight")``)
  2     + host-spilled hierarchy: coarse levels leave the card at the
        barriers and are re-uploaded into their own buckets during
        uncoarsening (the same arrays: the partition does not change)
  3     semi-external: the external scheme (external/) streams the fine
        graph until the coarse graph fits, under tight pads; on a
        classified degradation of the stream (not on a device fault)
        its fallback coarsens on the host in node-range chunks
  4     host-only: recursive bisection on the host, no device at all
  ====  =========================================================

:func:`begin_run` prices the whole graph and picks the starting rung
(the lowest whose estimate fits the budget, or ``KAMINPAR_TPU_MEM_RUNG``);
:func:`preflight` refuses an upload the current rung cannot fit;
:func:`run_ladder` retries a classified DeviceOOM (a real
``torch.OutOfMemoryError`` included) at the next rung, each step a
``degraded`` event; :func:`on_barrier` spills cold levels at rung >= 2
and, past PRESSURE_FRACTION of a budget, under pressure.  The live-bytes
figure is ``torch.cuda.memory_allocated`` on the card and 0 on the CPU.
``KAMINPAR_TPU_MEM_GOVERNOR=0`` disables the governor.  The external
scheme sizes its chunks and stream depth against the same budget.
"""

from __future__ import annotations

import gc
import os
import traceback
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from .. import caching
from . import runstate
from .errors import DegradationError, DeviceOOM, classify

#: Kill switch: =0 disables the governor (no ladder, no pressure hook).
ENV_GOVERNOR = "KAMINPAR_TPU_MEM_GOVERNOR"
#: The declared device-memory budget in bytes (when the context has none).
ENV_BUDGET = "KAMINPAR_TPU_HBM_BYTES"
#: Test hook: start the ladder at rung N (0-4).
ENV_FORCE_RUNG = "KAMINPAR_TPU_MEM_RUNG"

RUNG_NORMAL = 0
RUNG_TIGHT_PADS = 1
RUNG_SPILL_HIERARCHY = 2
RUNG_SEMI_EXTERNAL = 3
RUNG_HOST_ONLY = 4

RUNG_NAMES = {
    RUNG_NORMAL: "normal",
    RUNG_TIGHT_PADS: "tight-pads",
    RUNG_SPILL_HIERARCHY: "spill-hierarchy",
    RUNG_SEMI_EXTERNAL: "semi-external",
    RUNG_HOST_ONLY: "host-only",
}

#: Fraction of the budget at which the barrier hook spills proactively.
PRESSURE_FRACTION = 0.9
#: The streamed coarsening target: the coarse graph's estimate must fit
#: this fraction of the budget before the in-core pipeline takes over.
STREAM_TARGET_FRACTION = 0.8

#: Resident hierarchy factor over the finest level's CSR.
HIERARCHY_FACTOR = 1.5
#: Rung-2 resident factor: the working level and the one being reloaded.
SPILL_RESIDENT_FACTOR = 1.2
#: n_pad-shaped int32 working arrays live across launches.
NODE_WORK_ARRAYS = 2
#: m_pad-shaped int32 working arrays held across launches.
EDGE_WORK_ARRAYS = 1
#: k_pad-shaped tables (block weights, caps, per-block gains), int64.
K_TABLE_ARRAYS = 8
#: Bytes of one device weight (int32).
WEIGHT_BYTES = 4


# ---------------------------------------------------------------------------
# the peak-bytes estimator
# ---------------------------------------------------------------------------


def padded_bucket(n: int, m: int, k: int,
                  mode: str = "bucketed") -> Tuple[int, int, int]:
    """The padded shapes ``(n_pad, m_pad, k_pad)`` a run over (n, m, k)
    occupies under a pad policy — the unit the estimator prices."""
    from ..graphs.csr import shape_floors

    with caching.pad_policy_scope(mode):
        n_floor, m_floor = shape_floors()
        return (caching.pad_size(int(n) + 1, n_floor),
                caching.pad_size(max(int(m), 1), m_floor),
                caching.pad_k(max(int(k), 1)))


def device_csr_bytes(n_pad: int, m_pad: int) -> int:
    """Bytes of one padded device CSR + COO level (row_ptr, src, dst,
    edge_w, node_w)."""
    w = WEIGHT_BYTES
    return 4 * (n_pad + 1) + n_pad * (4 + w) + m_pad * (8 + w)


def _transient(n_pad: int, m_pad: int, k_pad: int) -> int:
    return (NODE_WORK_ARRAYS * n_pad * 4 + EDGE_WORK_ARRAYS * m_pad * 4
            + K_TABLE_ARRAYS * k_pad * 8)


def estimate_rung_bytes(rung: int, n: int, m: int, k: int) -> int:
    """Peak device bytes of a run at a ladder rung: rungs 0 and 1 price
    the resident hierarchy (bucketed, tight pads), rungs 2 and 3 the
    spilled hierarchy of the graph handed to the device, rung 4 nothing."""
    if rung >= RUNG_HOST_ONLY:
        return 0
    mode = "bucketed" if rung == RUNG_NORMAL else "tight"
    n_pad, m_pad, k_pad = padded_bucket(n, m, k, mode)
    csr = device_csr_bytes(n_pad, m_pad)
    factor = (HIERARCHY_FACTOR if rung <= RUNG_TIGHT_PADS
              else SPILL_RESIDENT_FACTOR)
    return int(factor * csr + _transient(n_pad, m_pad, k_pad))


def rung_fits(rung: int, n: int, m: int, k: int, budget: int) -> bool:
    """Whether a run over (n, m, k) can fit ``budget`` at a rung.  Rung 3
    fits when the smallest device graph (the floor bucket) does; rung 4
    always fits."""
    if rung >= RUNG_HOST_ONLY:
        return True
    if rung == RUNG_SEMI_EXTERNAL:
        fn, fm, fk = padded_bucket(0, 0, k, "tight")
        floor = (SPILL_RESIDENT_FACTOR * device_csr_bytes(fn, fm)
                 + _transient(fn, fm, fk))
        return floor <= budget
    return estimate_rung_bytes(rung, n, m, k) <= budget


def estimate_run_bytes(n: int, m: int, k: int, ctx: Any = None) -> int:
    """Estimated peak device bytes of a normal (rung-0) run over the
    padded shapes of (n, m, k).  ``ctx`` is accepted for signature
    parity."""
    del ctx
    return estimate_rung_bytes(RUNG_NORMAL, n, m, k)


def estimate_stream_bytes(n: int, chunk_edges: int, k: int) -> int:
    """Peak device bytes of the external scheme's stream phase: two
    in-flight padded chunk buffers (src_local, dst, weights), the fine
    level's O(n) vectors (labels, wanted, cluster weights, node weights,
    cluster map) and the k tables."""
    w = WEIGHT_BYTES
    e_pad = caching.pad_size(max(int(chunk_edges), 1), 4096)
    chunk = e_pad * (4 + 4 + w)
    vectors = int(n) * (4 + 4 + 4 + 2 * w)
    k_pad = caching.pad_k(max(int(k), 1))
    return int(2 * chunk + vectors + K_TABLE_ARRAYS * k_pad * 8)


def min_streamable_bytes(n: int, k: int) -> int:
    """The smallest budget the external scheme can stream a graph under
    (the floor chunk target of 2^15 edges)."""
    return estimate_stream_bytes(n, 1 << 15, k)


# ---------------------------------------------------------------------------
# budget + per-run governor state
# ---------------------------------------------------------------------------


def governor_enabled() -> bool:
    """False only under the KAMINPAR_TPU_MEM_GOVERNOR=0 kill switch."""
    return os.environ.get(ENV_GOVERNOR, "") != "0"


def budget_bytes(ctx: Any = None) -> Optional[int]:
    """The declared device-memory budget: ``ctx.resilience.memory_budget``
    when positive, else ``KAMINPAR_TPU_HBM_BYTES``; None when neither is
    declared."""
    if ctx is not None:
        res = getattr(ctx, "resilience", None)
        declared = float(getattr(res, "memory_budget", 0.0) or 0.0)
        if declared > 0:
            return int(declared)
    raw = os.environ.get(ENV_BUDGET, "")
    if raw:
        try:
            return int(float(raw))
        except ValueError:
            return None
    return None


def forced_rung() -> Optional[int]:
    """The KAMINPAR_TPU_MEM_RUNG test hook (None when unset)."""
    raw = os.environ.get(ENV_FORCE_RUNG, "")
    if not raw:
        return None
    try:
        return max(RUNG_NORMAL, min(RUNG_HOST_ONLY, int(raw)))
    except ValueError:
        return None


class GovernorState:
    """One run's governor state (on the thread-local RunState)."""

    __slots__ = (
        "budget", "rung", "initial_rung", "estimate", "bucket",
        "watermark", "pressure_events", "spills", "spill_bytes",
        "reloads", "reload_bytes", "shed_bytes", "exhausted",
        "engaged", "spiller", "graph_shape", "device",
    )

    def __init__(self) -> None:
        self.budget: Optional[int] = None
        self.rung: int = RUNG_NORMAL
        self.initial_rung: int = RUNG_NORMAL
        self.estimate: Optional[int] = None
        self.bucket: str = ""
        self.watermark: int = 0
        self.pressure_events: int = 0
        self.spills: int = 0
        self.spill_bytes: int = 0
        self.reloads: int = 0
        self.reload_bytes: int = 0
        self.shed_bytes: int = 0
        self.exhausted: bool = False
        self.engaged: bool = False  # any rung > 0 or pressure action
        self.spiller: Optional[weakref.ref] = None
        self.graph_shape: Tuple[int, int, int] = (0, 0, 0)
        self.device = None  # the run's torch.device


def state() -> Optional[GovernorState]:
    """The calling thread's governor state, or None when no run armed
    one."""
    return getattr(runstate.current(), "memory", None)


def _ensure_state() -> GovernorState:
    run = runstate.current()
    st = getattr(run, "memory", None)
    if st is None:
        st = GovernorState()
        run.memory = st
    return st


def begin_run(graph: Any, ctx: Any, device: Any = None
              ) -> Optional[GovernorState]:
    """Arm the governor for one run (facade entry): price the whole graph,
    pick the starting rung (the forced test rung, else the lowest rung
    whose estimate fits the declared budget) and emit the
    `memory-budget` event when a budget or a forced rung is in force.
    Returns None (dormant) under the kill switch."""
    if not governor_enabled():
        runstate.current().memory = None
        return None
    st = GovernorState()
    runstate.current().memory = st
    st.device = device
    st.budget = budget_bytes(ctx)
    n, m = int(graph.n), int(graph.m)
    k = int(getattr(ctx.partition, "k", 2) or 2)
    st.graph_shape = (n, m, k)
    st.bucket = "/".join(str(x) for x in padded_bucket(n, m, k))
    st.estimate = estimate_run_bytes(n, m, k)
    start = RUNG_NORMAL
    if st.budget:
        while (start < RUNG_HOST_ONLY
               and not rung_fits(start, n, m, k, st.budget)):
            start += 1
    hook = forced_rung()
    if hook is not None:
        start = hook
    st.rung = st.initial_rung = start
    if start > RUNG_NORMAL:
        st.engaged = True
        _emit_rung_event(
            st, error="MemoryBudgetExceeded",
            detail=(
                f"rung-0 estimate {st.estimate} > budget {st.budget}"
                if hook is None else f"{ENV_FORCE_RUNG}={hook}"
            ),
            injected=hook is not None,
        )
    if st.budget or start:
        from .. import telemetry

        telemetry.event(
            "memory-budget",
            budget_bytes=st.budget,
            estimate_bytes=st.estimate,
            bucket=st.bucket,
            rung=st.rung,
        )
    return st


def register_spiller(coarsener: Any) -> None:
    """The active coarsener registers itself as the spill target (weakly:
    the governor never keeps a dead hierarchy alive)."""
    st = state()
    if st is not None:
        st.spiller = weakref.ref(coarsener)


def note_spill(nbytes: int) -> None:
    st = state()
    if st is not None:
        st.spills += 1
        st.spill_bytes += int(nbytes)
        st.engaged = True


def note_reload(nbytes: int) -> None:
    st = state()
    if st is not None:
        st.reloads += 1
        st.reload_bytes += int(nbytes)


def live_device_bytes(device: Any = None) -> int:
    """Bytes the caching allocator holds in live tensors on the card (0
    on the CPU)."""
    import torch

    if device is None or getattr(device, "type", "cpu") != "cuda":
        return 0
    return int(torch.cuda.memory_allocated(device))


def on_barrier(stage: str) -> None:
    """The pressure hook at every checkpoint barrier (host side, between
    launches); two attribute reads while dormant.  At rung >= 2 cold
    levels are spilled unconditionally; with a budget, live bytes past
    PRESSURE_FRACTION of it shed caches and spill, with a
    `memory-pressure` event."""
    st = state()
    if st is None:
        return
    if st.rung >= RUNG_SPILL_HIERARCHY:
        spiller = st.spiller() if st.spiller is not None else None
        if spiller is not None:
            spiller.spill_cold_levels()
    if not st.budget:
        return
    live = live_device_bytes(st.device)
    if live > st.watermark:
        st.watermark = live
    if live <= PRESSURE_FRACTION * st.budget:
        return
    st.pressure_events += 1
    st.engaged = True
    freed = 0  # this package keeps no sheddable caches
    spilled = 0
    spiller = st.spiller() if st.spiller is not None else None
    if spiller is not None:
        spilled = spiller.spill_cold_levels()
    from .. import telemetry
    from ..utils.logger import log_warning

    telemetry.event(
        "memory-pressure",
        stage=stage,
        live_bytes=live,
        budget_bytes=st.budget,
        cache_bytes_freed=freed,
        spill_bytes=spilled,
    )
    log_warning(
        f"memory pressure at {stage}: live {live} > "
        f"{PRESSURE_FRACTION:.0%} of budget {st.budget} — shed {freed} "
        f"cache bytes, spilled {spilled} hierarchy bytes"
    )


def preflight(n: int, m: int, k: int, where: str = "") -> None:
    """The pre-upload budget check of the schemes: raises a
    ladder-retryable DeviceOOM when the current rung's estimate cannot
    fit the declared budget.  Dormant without a budget."""
    st = state()
    if st is None or not st.budget:
        return
    est = estimate_rung_bytes(st.rung, n, m, k)
    if est <= st.budget:
        return
    raise DeviceOOM(
        f"preflight{'@' + where if where else ''}: rung-{st.rung} "
        f"estimate {est} bytes exceeds the declared budget "
        f"{st.budget} bytes (n={n}, m={m}, k={k})",
        site="device-oom",
    )


# ---------------------------------------------------------------------------
# the recovery ladder
# ---------------------------------------------------------------------------


def _emit_rung_event(st: GovernorState, error: str, detail: str,
                     injected: bool = False) -> None:
    from .. import telemetry
    from ..utils.logger import log_warning
    from .faults import SITES

    spec = SITES.get("device-oom")
    telemetry.event(
        "degraded",
        site="device-oom",
        error=error,
        detail=detail[:300],
        fallback=spec.fallback if spec else "recovery ladder",
        attempts=st.rung,
        breaker_open=False,
        injected=injected,
        rung=st.rung,
        rung_name=RUNG_NAMES.get(st.rung, str(st.rung)),
    )
    log_warning(
        f"memory governor: {error} ({detail[:120]}); retrying at rung "
        f"{st.rung} ({RUNG_NAMES.get(st.rung)})"
    )


def _release(exc: BaseException) -> None:
    """Drop the frames of a failed attempt: a torch exception's traceback
    keeps every tensor of the dead attempt alive, and the next rung would
    run out of memory on what rung 0 still holds."""
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        traceback.clear_frames(exc.__traceback__)
        exc.__traceback__ = None
        nxt = exc.__cause__ or exc.__context__
        exc.__cause__ = None
        exc.__context__ = None
        exc = nxt


def _recover(st: GovernorState, depth: int) -> None:
    """Unwind one failed attempt: close the timer scopes it left open,
    collect the dead attempt's tensors and hand the cached blocks back to
    the card."""
    from ..utils import timer

    timer.GLOBAL_TIMER.unwind_to(depth)
    gc.collect()
    dev = st.device
    if dev is not None and getattr(dev, "type", "cpu") == "cuda":
        import torch

        torch.cuda.empty_cache()


def run_ladder(attempt: Callable[[], np.ndarray], graph: Any, ctx: Any,
               facade: Any) -> np.ndarray:
    """Run the core partition under the OOM recovery ladder: rungs 0-2
    re-run ``attempt`` under more frugal policies, rungs 3-4 substitute
    the semi-external and host-only paths.  A non-OOM exception
    propagates; when every rung failed the DeviceOOM is re-raised with
    ``rungs_exhausted=True``."""
    if not governor_enabled():
        return attempt()
    from ..utils import timer

    st = state()
    rung = st.rung if st is not None else RUNG_NORMAL
    while True:
        if st is not None:
            st.rung = rung
        depth = len(timer.GLOBAL_TIMER._stack)
        failure = None
        try:
            return _attempt_at_rung(rung, attempt, graph, ctx, facade)
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception as exc:
            err = classify(exc, site="device-oom")
            if not isinstance(err, DeviceOOM):
                raise
            if st is None:
                st = _ensure_state()
                st.rung = rung
            if rung >= RUNG_HOST_ONLY:
                st.exhausted = True
                err.rungs_exhausted = True
                from .. import telemetry
                from ..utils.logger import log_warning

                telemetry.annotate(memory_budget=summary())
                log_warning(
                    "memory governor: recovery ladder EXHAUSTED "
                    f"(host-only rung failed: {err})"
                )
                raise err from exc
            failure = (type(err).__name__, str(err), err.injected)
            _release(exc)
            _release(err)
            err = None
        rung += 1
        st.rung = rung
        st.engaged = True
        _recover(st, depth)
        _emit_rung_event(st, error=failure[0], detail=failure[1],
                         injected=failure[2])


def _attempt_at_rung(rung: int, attempt: Callable[[], np.ndarray],
                     graph: Any, ctx: Any, facade: Any) -> np.ndarray:
    if rung == RUNG_NORMAL:
        return attempt()
    if rung in (RUNG_TIGHT_PADS, RUNG_SPILL_HIERARCHY):
        # rung 2 spills at the barriers (on_barrier reads the rung)
        with caching.pad_policy_scope("tight"):
            return attempt()
    if rung == RUNG_SEMI_EXTERNAL:
        with caching.pad_policy_scope("tight"):
            return _semi_external_rung(graph, ctx, facade)
    return host_only_partition(graph, ctx)


def _semi_external_rung(graph: Any, ctx: Any, facade: Any) -> np.ndarray:
    """Rung 3's primary is the device-streamed external scheme.  A
    classified degradation of it other than DeviceOOM (a DegradationError,
    which is what an injected fault raises) degrades to the host-chunked
    LP path (:func:`semi_external_partition`) with a ``degraded`` event;
    a DeviceOOM, or a raw out-of-memory error, moves the ladder on to
    host-only.  Any other exception (a kernel that does not build or
    launch, a CUDA error) propagates: the work never moves to the host
    behind a device fault.  (The JAX package's rung 3 falls back on
    every non-OOM exception.)"""
    from ..external.driver import ExternalPartitioner

    try:
        scheme = ExternalPartitioner(ctx, facade.device)
        part = scheme.partition(graph)
        facade.last_timings = dict(scheme.timings)
        facade.last_levels = list(scheme.levels)
        facade.last_external = scheme.section
        return part
    except DegradationError as exc:
        if isinstance(exc, DeviceOOM):
            raise
        from .. import telemetry
        from ..utils.logger import log_warning

        telemetry.event(
            "degraded",
            site="semi-external-stream",
            error=type(exc).__name__,
            detail=str(exc)[:300],
            fallback="host-chunked numpy LP (semi_external_partition)",
            attempts=1,
            breaker_open=False,
            injected=False,
        )
        log_warning(
            f"semi-external stream failed ({type(exc).__name__}: "
            f"{str(exc)[:120]}); falling back to the host-chunked LP path"
        )
        return semi_external_partition(graph, ctx, facade)


# ---------------------------------------------------------------------------
# rung 3's fallback: semi-external partitioning (host-chunked coarsening)
# ---------------------------------------------------------------------------


def _node_chunks(graph: Any, chunk_nodes: int):
    """Stream ``(v0, v1, deg, adj, ew)`` node-range blocks of a host or
    compressed graph (peak host memory: one block)."""
    from ..graphs.compressed import CompressedHostGraph

    n = int(graph.n)
    if isinstance(graph, CompressedHostGraph):
        for v0 in range(0, n, chunk_nodes):
            v1 = min(n, v0 + chunk_nodes)
            xr, adj, ew = graph.decode_range(v0, v1)
            deg = np.diff(np.asarray(xr, dtype=np.int64))
            yield v0, v1, deg, np.asarray(adj), (
                None if ew is None else np.asarray(ew)
            )
    else:
        xadj = np.asarray(graph.xadj, dtype=np.int64)
        ew_all = graph.edge_weights
        for v0 in range(0, n, chunk_nodes):
            v1 = min(n, v0 + chunk_nodes)
            lo, hi = int(xadj[v0]), int(xadj[v1])
            deg = np.diff(xadj[v0: v1 + 1])
            yield v0, v1, deg, np.asarray(graph.adjncy[lo:hi]), (
                None if ew_all is None else np.asarray(ew_all[lo:hi])
            )


def _host_lp_cluster(graph: Any, max_cluster_weight: int,
                     num_iterations: int = 2,
                     chunk_nodes: int = 1 << 17) -> np.ndarray:
    """Chunked host label propagation: per chunk, exact best-neighbor
    ratings (lexsort + reduceat), moves gated by the cluster weight cap
    with an exact per-target prefix check.  Deterministic: ties break
    toward the lower label.  Returns compacted cluster labels."""
    n = int(graph.n)
    node_w = np.asarray(graph.node_weight_array(), dtype=np.int64)
    labels = np.arange(n, dtype=np.int64)
    cl_w = node_w.copy()
    cap = int(max_cluster_weight)
    for _ in range(max(1, num_iterations)):
        moved = 0
        for v0, v1, deg, adj, ew in _node_chunks(graph, chunk_nodes):
            if len(adj) == 0:
                continue
            rows = np.repeat(np.arange(v0, v1, dtype=np.int64), deg)
            tl = labels[adj]
            w = (np.ones(len(adj), dtype=np.int64) if ew is None
                 else np.asarray(ew, dtype=np.int64))
            order = np.lexsort((tl, rows))
            r, t, w = rows[order], tl[order], w[order]
            new_grp = np.empty(len(r), dtype=bool)
            new_grp[0] = True
            new_grp[1:] = (r[1:] != r[:-1]) | (t[1:] != t[:-1])
            starts = np.flatnonzero(new_grp)
            rating = np.add.reduceat(w, starts)
            gr, gt = r[starts], t[starts]
            o2 = np.lexsort((gt, -rating, gr))
            gr2, gt2 = gr[o2], gt[o2]
            firsts = np.flatnonzero(np.r_[True, gr2[1:] != gr2[:-1]])
            best_row, best_lab = gr2[firsts], gt2[firsts]
            cur = labels[best_row]
            nw = node_w[best_row]
            ok = (best_lab != cur) & (cl_w[best_lab] + nw <= cap)
            if not ok.any():
                continue
            rows_ok, labs_ok, nw_ok = best_row[ok], best_lab[ok], nw[ok]
            # per target label, accept the longest prefix (by node id)
            # whose cumulative weight fits the headroom: the cap holds
            order2 = np.lexsort((rows_ok, labs_ok))
            rows_ok, labs_ok = rows_ok[order2], labs_ok[order2]
            nw_ok = nw_ok[order2]
            grp = np.flatnonzero(np.r_[True, labs_ok[1:] != labs_ok[:-1]])
            cum = np.cumsum(nw_ok)
            base = np.repeat(cum[grp] - nw_ok[grp],
                             np.diff(np.r_[grp, len(labs_ok)]))
            accept = (cum - base) <= (cap - cl_w[labs_ok])
            if not accept.any():
                continue
            rows_ok, labs_ok = rows_ok[accept], labs_ok[accept]
            np.subtract.at(cl_w, labels[rows_ok], node_w[rows_ok])
            labels[rows_ok] = labs_ok
            np.add.at(cl_w, labs_ok, node_w[rows_ok])
            moved += int(len(rows_ok))
        if moved == 0:
            break
    _, compact = np.unique(labels, return_inverse=True)
    return compact.astype(np.int64)


def _host_contract(graph: Any, labels: np.ndarray,
                   chunk_nodes: int = 1 << 17):
    """Chunked host contraction: inter-cluster edges aggregated block by
    block.  Returns the coarse HostGraph and the fine->coarse map."""
    from ..graphs.host import HostGraph

    c_n = int(labels.max()) + 1 if len(labels) else 0
    node_w = np.asarray(graph.node_weight_array(), dtype=np.int64)
    cw = np.zeros(c_n, dtype=np.int64)
    np.add.at(cw, labels, node_w)

    acc_key = np.empty(0, dtype=np.int64)
    acc_w = np.empty(0, dtype=np.int64)

    def dedup(keys, weights):
        uk, inv = np.unique(keys, return_inverse=True)
        uw = np.zeros(len(uk), dtype=np.int64)
        np.add.at(uw, inv, weights)
        return uk, uw

    for v0, v1, deg, adj, ew in _node_chunks(graph, chunk_nodes):
        if len(adj) == 0:
            continue
        rows = np.repeat(np.arange(v0, v1, dtype=np.int64), deg)
        cu, cv = labels[rows], labels[adj]
        keep = cu != cv
        key = cu[keep] * c_n + cv[keep]
        w = (np.ones(int(keep.sum()), dtype=np.int64) if ew is None
             else np.asarray(ew, dtype=np.int64)[keep])
        k2, w2 = dedup(key, w)
        acc_key = np.concatenate([acc_key, k2])
        acc_w = np.concatenate([acc_w, w2])
        if len(acc_key) > 4 * max(len(k2), 1 << 20):
            acc_key, acc_w = dedup(acc_key, acc_w)
    acc_key, acc_w = dedup(acc_key, acc_w)
    cu = (acc_key // c_n).astype(np.int64)
    cv = (acc_key % c_n).astype(np.int32)
    xadj = np.zeros(c_n + 1, dtype=np.int64)
    np.add.at(xadj, cu + 1, 1)
    np.cumsum(xadj, out=xadj)
    coarse = HostGraph(xadj=xadj, adjncy=cv, node_weights=cw,
                       edge_weights=acc_w)
    return coarse, labels.astype(np.int32)


def semi_external_partition(graph: Any, ctx: Any, facade: Any) -> np.ndarray:
    """Coarsen the fine graph on the host in node-range chunks until the
    coarse graph's spilled-mode estimate fits the budget, run the device
    pipeline on it and project back through the host cmaps."""
    from .. import telemetry
    from ..utils import timer
    from ..utils.logger import log_progress

    st = state()
    budget = st.budget if st is not None else None
    k = int(ctx.partition.k)
    target = int(budget * STREAM_TARGET_FRACTION) if budget else None
    cmaps: List[np.ndarray] = []
    current = graph
    cap = max(1, int(ctx.coarsening.max_cluster_weight(
        int(graph.n), int(ctx.partition.total_node_weight), ctx.partition,
    )))
    with timer.scoped_timer("semi-external-coarsening"):
        for level in range(32):
            n, m = int(current.n), int(current.m)
            fits = (target is None
                    or estimate_rung_bytes(RUNG_SPILL_HIERARCHY, n, m, k)
                    <= target)
            if fits or n <= max(2 * ctx.coarsening.contraction_limit, 2):
                break
            labels = _host_lp_cluster(current, cap)
            c_n = int(labels.max()) + 1 if len(labels) else 0
            if c_n >= 0.95 * n:
                cap *= 2  # stalled: relax the cap once
                labels = _host_lp_cluster(current, cap)
                c_n = int(labels.max()) + 1 if len(labels) else 0
                if c_n >= 0.95 * n:
                    break
            current, cmap = _host_contract(current, labels)
            cmaps.append(cmap)
            log_progress(f"semi-external level {level}: n={current.n} "
                         f"m={current.m} (host-resident)")
    telemetry.event("semi-external", levels=len(cmaps),
                    coarse_n=int(current.n), coarse_m=int(current.m))
    part = np.asarray(facade._partition_core_resilient(current),
                      dtype=np.int32)
    with timer.scoped_timer("semi-external-projection"):
        for cmap in reversed(cmaps):
            part = part[cmap]
    return part


# ---------------------------------------------------------------------------
# rung 4: host-only partitioning
# ---------------------------------------------------------------------------


def host_only_partition(graph: Any, ctx: Any) -> np.ndarray:
    """Recursive bisection entirely on the host (the sequential pool
    bipartitioner), no device arrays; the output gate still checks and
    repairs balance."""
    from .. import telemetry
    from ..graphs.compressed import CompressedHostGraph
    from ..partitioning.rb import recursive_bipartition
    from ..utils import timer
    from ..utils.rng import host_rng

    hg = graph.decode() if isinstance(graph, CompressedHostGraph) else graph
    k = int(ctx.partition.k)
    telemetry.event("host-only-partition", n=int(hg.n), m=int(hg.m), k=k)
    with timer.scoped_timer("host-only-partitioning"):
        part = recursive_bipartition(
            hg, k, ctx, host_rng(ctx.seed, ctx.seed ^ 0x40F7)
        )
    return np.asarray(part, dtype=np.int32)


# ---------------------------------------------------------------------------
# reporting
# ---------------------------------------------------------------------------


def summary() -> dict:
    """The run report's ``memory_budget`` section; ``enabled`` when a
    budget was declared or the ladder engaged."""
    st = state()
    if st is None:
        return {"enabled": False}
    d: Dict[str, Any] = {
        "enabled": bool(st.budget or st.engaged),
        "rung": int(st.rung),
        "rung_name": RUNG_NAMES.get(st.rung, str(st.rung)),
        "initial_rung": int(st.initial_rung),
        "exhausted": bool(st.exhausted),
        "spills": {
            "count": int(st.spills),
            "bytes": int(st.spill_bytes),
            "reloads": int(st.reloads),
            "reload_bytes": int(st.reload_bytes),
        },
        "pressure_events": int(st.pressure_events),
        "shed_cache_bytes": int(st.shed_bytes),
    }
    if st.budget is not None:
        d["budget_bytes"] = int(st.budget)
    if st.estimate is not None:
        d["estimate_bytes"] = int(st.estimate)
    if st.bucket:
        d["bucket"] = st.bucket
    if st.watermark:
        d["watermark_bytes"] = int(st.watermark)
    return d
