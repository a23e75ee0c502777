"""Warm-started v-cycle repartitioning policy (own copy of
kaminpar_tpu/dynamic/repartition.py).

Per repartition request:

  1. **seed**: vertices added since the last repartition get labels by
     weighted neighbour-majority vote (ties to the smaller block);
     isolated newcomers fill blocks by headroom;
  2. **drift estimate**: accumulated delta edge mass touching the cut
     over the total edge mass, plus the balance violation after the
     patch (``GraphSession.drift_estimate``);
  3. **decide**: drift under ``ctx.dynamic.drift_threshold`` runs the
     warm path, the v-cycle scheme started from the previous partition
     with ``ctx.dynamic.warm_levels`` of restricted coarsening (0: a
     refinement pass at the fine level, which launches K1 and K2; its
     restricted LP takes sort2 in both packages, so not the fused K3);
     above it a cold run; ``ctx.dynamic.replicas >= 2`` races the warm
     run against cold replicas and keeps the better cut;
  4. **gate**: the result is held against the pre-delta cut by the
     ``telemetry.diff`` cut gate; a warm result it rejects escalates to
     a cold retry (``ctx.dynamic.cold_fallback``) and the better of the
     two is kept.

Every run goes through the facade on ``device`` (the card unless the
caller asks for the CPU).  Every decision emits a ``dynamic`` telemetry
event after the compute, so the facade's per-run stream reset cannot
swallow it, and the outcome is committed back into the session.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..device import DeviceLike
from .session import GraphSession


@dataclass
class RepartitionOutcome:
    """One repartition decision + result — the run report's
    ``dynamic.decisions`` row."""

    partition: np.ndarray
    cut: int
    imbalance: float
    feasible: bool
    gate_valid: Optional[bool]
    mode: str  # warm | cold | replica
    drift: Optional[float]
    cut_before: Optional[int]
    stable: Optional[bool]
    escalated: bool
    seeded: int
    wall_s: float
    warm_wall_s: Optional[float]
    cold_wall_s: Optional[float]
    replica_cuts: List[int] = field(default_factory=list)
    anytime: Optional[dict] = None
    degraded_sites: List[str] = field(default_factory=list)

    def to_row(self, session_id: str = "", step: Optional[int] = None
               ) -> dict:
        row = {
            "session": session_id,
            "mode": self.mode,
            "drift": (None if self.drift is None
                      else round(float(self.drift), 6)),
            "cut_before": (None if self.cut_before is None
                           else int(self.cut_before)),
            "cut": int(self.cut),
            "feasible": bool(self.feasible),
            "stable": self.stable,
            "escalated": bool(self.escalated),
            "seeded": int(self.seeded),
            "wall_s": round(float(self.wall_s), 4),
            "warm_wall_s": (None if self.warm_wall_s is None
                            else round(float(self.warm_wall_s), 4)),
            "cold_wall_s": (None if self.cold_wall_s is None
                            else round(float(self.cold_wall_s), 4)),
        }
        if step is not None:
            row["step"] = int(step)
        if self.gate_valid is not None:
            row["gate_valid"] = bool(self.gate_valid)
        if self.replica_cuts:
            row["replica_cuts"] = [int(c) for c in self.replica_cuts]
        if self.degraded_sites:
            row["degraded_sites"] = list(self.degraded_sites)
        return row


def seed_new_vertices(graph, partition, k: int,
                      max_block_weights=None) -> tuple:
    """Label every ``-1`` entry of ``partition`` by weighted
    neighbor-majority vote (a few bounded passes cover chains of new
    vertices voting for each other); newcomers with no labeled neighbor
    fill blocks by headroom.  Returns (partition, seeded_count)."""
    from ..kaminpar import _fill_blocks_by_headroom

    part = np.asarray(partition, dtype=np.int32).copy()
    total_seeded = int((part < 0).sum())
    if total_seeded == 0:
        return part, 0
    xadj = np.asarray(graph.xadj, dtype=np.int64)
    adj = np.asarray(graph.adjncy, dtype=np.int64)
    ew = graph.edge_weight_array()
    for _ in range(3):
        un = np.flatnonzero(part < 0)
        if not len(un):
            break
        deg = (xadj[un + 1] - xadj[un]).astype(np.int64)
        idx = np.repeat(xadj[un], deg) + (
            np.arange(int(deg.sum()), dtype=np.int64)
            - np.repeat(np.cumsum(deg) - deg, deg)
        )
        rows = np.repeat(np.arange(len(un), dtype=np.int64), deg)
        lab = part[adj[idx]]
        valid = lab >= 0
        if not valid.any():
            break
        votes = np.zeros((len(un), k), dtype=np.int64)
        np.add.at(votes, (rows[valid], lab[valid]),
                  ew[idx][valid].astype(np.int64))
        got = votes.max(axis=1) > 0
        if not got.any():
            break
        # argmax ties break to the smaller block id by construction
        part[un[got]] = votes[got].argmax(axis=1).astype(np.int32)
    un = np.flatnonzero(part < 0)
    if len(un):
        nw = graph.node_weight_array()
        bw = np.zeros(k, dtype=np.int64)
        labeled = part >= 0
        np.add.at(bw, part[labeled], nw[labeled])
        caps = (
            np.asarray(max_block_weights, dtype=np.int64)
            if max_block_weights is not None
            else np.full(k, np.int64(2) * max(
                int(nw.sum()) // max(k, 1), 1), dtype=np.int64)
        )
        part[un] = _fill_blocks_by_headroom(nw[un], bw, caps)
    return part, total_seeded


def _default_caps(graph, k: int, epsilon: float) -> np.ndarray:
    total = int(graph.total_node_weight)
    perfect = max(1, -(-total // max(k, 1)))
    return np.full(k, int(perfect * (1.0 + epsilon)) + 1, dtype=np.int64)


def repartition(session: GraphSession, ctx=None, *,
                k: Optional[int] = None,
                epsilon: Optional[float] = None,
                seed: Optional[int] = None,
                quiet: bool = True,
                device: DeviceLike = "cuda") -> RepartitionOutcome:
    """Run the warm/cold/replica policy for the session's current graph
    on `device` and commit the result back into the session."""
    from .. import telemetry
    from ..context import PartitioningMode
    from ..kaminpar import KaMinPar
    from ..presets import create_context_by_preset_name
    from ..telemetry.diff import diff_reports
    from ..utils.logger import OutputLevel

    if ctx is None:
        ctx = create_context_by_preset_name("default")
    dctx = ctx.dynamic
    k = int(k) if k else int(session.k)
    k_changed = k != session.k
    session.set_k(k)
    # epsilon=None defers to the configured ctx.partition.epsilon
    # (PartitionContext.setup keeps it), matching the single-shot path
    eps = (float(epsilon) if epsilon is not None
           else float(ctx.partition.epsilon))
    caps = _default_caps(session.graph, k, eps)

    seeded = 0
    warm_seed_part = None
    if session.partition is not None and not k_changed:
        warm_seed_part, seeded = seed_new_vertices(
            session.graph, session.partition, k,
            max_block_weights=caps,
        )
    drift = session.drift_estimate(caps) if warm_seed_part is not None \
        else None

    if warm_seed_part is None:
        mode = "cold"
    elif int(dctx.replicas) > 1:
        mode = "replica"
    elif drift is not None and drift > float(dctx.drift_threshold):
        mode = "cold"
    else:
        mode = "warm"

    def _run(run_mode: str, warm_part=None, seed_offset: int = 0,
             checkpoint: bool = True) -> dict:
        run_ctx = ctx.copy()
        if warm_part is not None:
            run_ctx.partitioning.mode = PartitioningMode.VCYCLE
        if not checkpoint:
            # only the primary attempt owns the per-step manifest —
            # racers/escalations re-run deterministically on resume
            run_ctx.resilience.checkpoint_dir = ""
            run_ctx.resilience.resume = False
        solver = KaMinPar(run_ctx, device=device)
        if quiet:
            solver.set_output_level(OutputLevel.QUIET)
        solver.set_graph(session.graph)
        if warm_part is not None:
            solver.set_initial_partition(
                warm_part, max_levels=int(dctx.warm_levels))
        t0 = time.perf_counter()
        part = solver.compute_partition(
            k=k, epsilon=epsilon,  # None keeps the ctx-configured value
            seed=(seed + seed_offset) if seed is not None else None,
        )
        wall = time.perf_counter() - t0
        metrics = solver.result_metrics(session.graph, part)
        gate_valid = telemetry.gate_verdict()
        sites = sorted({
            e.attrs.get("site", "") for e in telemetry.events("degraded")
        } - {""})
        return {
            "kind": run_mode,
            "part": part,
            "cut": int(metrics["cut"]),
            "imbalance": float(metrics["imbalance"]),
            "feasible": bool(metrics["feasible"]),
            "gate_valid": gate_valid,
            "wall_s": wall,
            "anytime": solver.last_anytime,
            "degraded": sites,
        }

    runs: List[dict] = []
    warm_wall = cold_wall = None
    if mode == "cold":
        runs.append(_run("cold"))
        cold_wall = runs[-1]["wall_s"]
    elif mode == "warm":
        runs.append(_run("warm", warm_part=warm_seed_part))
        warm_wall = runs[-1]["wall_s"]
    else:  # replica race: warm + (replicas - 1) cold twins
        runs.append(_run("warm", warm_part=warm_seed_part))
        warm_wall = runs[-1]["wall_s"]
        for r in range(max(int(dctx.replicas) - 1, 1)):
            runs.append(_run("cold", seed_offset=r + 1, checkpoint=False))
            cold_wall = runs[-1]["wall_s"]

    def _better(a: dict, b: dict) -> dict:
        if a["feasible"] != b["feasible"]:
            return a if a["feasible"] else b
        return a if a["cut"] <= b["cut"] else b

    best = runs[0]
    for other in runs[1:]:
        best = _better(best, other)

    cut_before = session.last_cut

    def _stable(cand: dict) -> Optional[bool]:
        if cut_before is None:
            return None
        _, failures = diff_reports(
            {"result": {"cut": int(cut_before), "feasible": True}},
            {"result": {"cut": int(cand["cut"]),
                        "feasible": bool(cand["feasible"])}},
            cut_threshold=float(dctx.cut_gate_threshold),
        )
        return not failures

    stable = _stable(best)
    escalated = False
    if (
        mode == "warm" and stable is False and bool(dctx.cold_fallback)
    ):
        # the diff gate rejected the warm result: escalate to a cold
        # run and keep the better of the two (PASCO's escape hatch for
        # drift the estimator under-called)
        cold = _run("cold", checkpoint=False)
        cold_wall = cold["wall_s"]
        escalated = True
        best = _better(best, cold)
        stable = _stable(best)

    session.commit_partition(
        best["part"], best["cut"], gate_valid=best["gate_valid"])

    outcome = RepartitionOutcome(
        partition=best["part"],
        cut=best["cut"],
        imbalance=best["imbalance"],
        feasible=best["feasible"],
        gate_valid=best["gate_valid"],
        mode=mode,
        drift=drift,
        cut_before=cut_before,
        stable=stable,
        escalated=escalated,
        seeded=seeded,
        wall_s=sum(r["wall_s"] for r in runs) + (
            cold_wall if escalated else 0.0),
        warm_wall_s=warm_wall,
        cold_wall_s=cold_wall,
        replica_cuts=[r["cut"] for r in runs] if mode == "replica"
        else [],
        anytime=best.get("anytime"),
        degraded_sites=best["degraded"],
    )
    # emitted AFTER the compute: the facade resets the telemetry stream
    # at compute entry, so this lands in the (final) run's stream and
    # survives into its report
    telemetry.event(
        "dynamic", action="repartition", session=session.id,
        mode=mode, drift=outcome.to_row()["drift"],
        cut_before=outcome.cut_before, cut=outcome.cut,
        stable=stable, escalated=escalated, seeded=seeded,
    )
    return outcome
