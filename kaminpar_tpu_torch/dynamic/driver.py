"""Delta-chain driving and the ``dynamic`` report section (own copy of
kaminpar_tpu/dynamic/driver.py).

``run_chain`` is the driver behind the CLI's ``--delta-batch``: register
the base graph (a cold partition), then per delta batch apply, then a
warm or cold repartition (step i at ``seed + i``), with per-step
checkpoint and resume on top of the facade's own manager:

  * each step's compute runs under the session's evolving fingerprint,
    so the facade's checkpoint manifest keys on the exact chain position
    and a kill mid-step resumes that step through ``--resume``;
  * after every completed step the driver writes its chain state (step,
    chain hash, partition, per-step partition digests) under
    ``<checkpoint-dir>/dynamic/``; a resume re-applies the deterministic
    deltas, re-folds the recorded repartition markers, checks the
    rebuilt chain hash against the stored one and restores the
    partition, and the interrupted step is the first to recompute.

``random_delta_batch`` and ``synth_chain`` synthesize churn batches from
``numpy.random.default_rng(seed)``: the JAX package's batches, draw for
draw.  ``summarize`` assembles the schema's ``dynamic`` report section.
"""

from __future__ import annotations

import json
import os
from typing import Callable, List, Optional, Tuple

import numpy as np

from ..device import DeviceLike
from .repartition import RepartitionOutcome, repartition
from .session import DeltaBatch, GraphSession

CHAIN_STATE_DIR = "dynamic"
CHAIN_STATE_JSON = "chain-state.json"
CHAIN_STATE_NPZ = "chain-part.npz"


def random_delta_batch(graph, seed: int, edge_churn: float = 0.01,
                       insert_frac: float = 0.5,
                       vertex_adds: int = 0,
                       weighted: bool = False,
                       uniform_frac: float = 0.0) -> DeltaBatch:
    """A synthetic churn batch: delete about ``edge_churn *
    (1 - insert_frac)`` of the undirected edges and insert about
    ``edge_churn * insert_frac`` new ones (plus optional appended
    vertices, each wired to a random existing node so seeding has
    neighbors to vote with).  Deterministic in (graph, seed).

    Inserts default to **triadic closure** (new edges close wedges:
    two neighbors of a shared node), which is how real dynamic graphs
    churn — and what keeps the churn warm-startable.  ``uniform_frac``
    mixes in uniformly random endpoint pairs, which in a structured
    graph are almost all *intrinsic cut edges* no refinement can
    remove: the adversarial end of the drift spectrum (tests use it to
    force the cold/escalation paths)."""
    rng = np.random.default_rng(seed)
    n = graph.n
    src = graph.edge_sources().astype(np.int64)
    dst = np.asarray(graph.adjncy, dtype=np.int64)
    xadj = np.asarray(graph.xadj, dtype=np.int64)
    half = src < dst
    und = np.stack([src[half], dst[half]], axis=1)
    m_und = len(und)
    ops = max(1, int(m_und * edge_churn))
    n_ins = max(1, int(ops * insert_frac))
    # insert_frac=1.0 means a pure-growth batch — no hidden delete
    # (callers sizing a batch to cross a padded bucket exactly rely on
    # the net growth being the insert count)
    n_del = ops - n_ins if insert_frac >= 1.0 else max(1, ops - n_ins)

    deletes = und[rng.choice(m_und, size=max(min(n_del, m_und), 0),
                             replace=False)] if m_und else und[:0]

    n_total = n + vertex_adds
    existing = set(int(a) * (n_total + 1) + int(b) for a, b in und)

    def _take(cand: np.ndarray, want: int,
              out: List[Tuple[int, int]]) -> None:
        if not len(cand):
            return
        lo = np.minimum(cand[:, 0], cand[:, 1])
        hi = np.maximum(cand[:, 0], cand[:, 1])
        ok = lo != hi
        for a, b in zip(lo[ok], hi[ok]):
            key = int(a) * (n_total + 1) + int(b)
            if key in existing:
                continue
            existing.add(key)
            out.append((int(a), int(b)))
            if len(out) >= want:
                return

    inserts: List[Tuple[int, int]] = []
    n_uni = int(round(n_ins * max(0.0, min(1.0, uniform_frac))))
    n_tri = n_ins - n_uni
    deg = (xadj[1:] - xadj[:-1]).astype(np.int64)
    wedge_nodes = np.flatnonzero(deg >= 2)
    guard = 0
    while len(inserts) < n_tri and len(wedge_nodes) and guard < 50:
        guard += 1
        u = wedge_nodes[rng.integers(0, len(wedge_nodes),
                                     size=4 * n_tri)]
        o1 = rng.integers(0, deg[u])
        o2 = rng.integers(0, deg[u] - 1)
        o2 = np.where(o2 >= o1, o2 + 1, o2)  # two DISTINCT neighbors
        cand = np.stack([dst[xadj[u] + o1], dst[xadj[u] + o2]], axis=1)
        _take(cand, n_tri, inserts)
    guard = 0
    while len(inserts) < n_ins and guard < 50:
        guard += 1
        _take(rng.integers(0, n_total, size=(4 * n_ins, 2)),
              n_ins, inserts)
    ins = np.asarray(inserts, dtype=np.int64).reshape(-1, 2)
    # every appended vertex gets at least one edge to an existing node
    extra = []
    for v in range(n, n_total):
        if not len(ins) or not (ins == v).any():
            u = int(rng.integers(0, n))
            key = min(u, v) * (n_total + 1) + max(u, v)
            if key not in existing:
                existing.add(key)
                extra.append((min(u, v), max(u, v)))
    if extra:
        ins = np.concatenate(
            [ins, np.asarray(extra, dtype=np.int64)], axis=0)
    return DeltaBatch(
        edge_inserts=ins,
        insert_weights=(
            rng.integers(1, 4, size=len(ins)) if weighted else None),
        edge_deletes=deletes,
        vertex_adds=vertex_adds,
    )


def synth_chain(graph, steps: int, seed: int, edge_churn: float = 0.01,
                vertex_adds_every: int = 0,
                uniform_frac: float = 0.0) -> List[DeltaBatch]:
    """A chain of churn batches, each synthesized against the graph AS
    MUTATED by its predecessors (a batch generated from the base graph
    would delete edges an earlier batch already removed).  Used by the
    tests, the bench dynamic measurement, and the check_all smoke."""
    scratch = GraphSession("synth", graph, k=2)
    out: List[DeltaBatch] = []
    try:
        for i in range(steps):
            adds = (
                1 if vertex_adds_every
                and (i + 1) % vertex_adds_every == 0 else 0
            )
            b = random_delta_batch(
                scratch.graph, seed=seed + i, edge_churn=edge_churn,
                vertex_adds=adds, uniform_frac=uniform_frac,
            )
            scratch.apply(b)
            out.append(b)
    finally:
        # the scratch session stamped ITS identity onto the caller's
        # graph object; strip it so the caller's checkpoint/cache
        # identity is unchanged by this synthesis pass
        for attr in ("_session_fp", "_chain_digest"):
            if hasattr(graph, attr):
                delattr(graph, attr)
    return out


def load_delta_file(path: str) -> List[DeltaBatch]:
    """Parse a ``--delta-batch`` JSON file: either a bare array of
    delta objects or ``{"deltas": [...]}`` (DeltaBatch.from_dict wire
    form).  Raises io.GraphFormatError on malformed content."""
    from ..io.errors import GraphFormatError

    try:
        with open(path) as f:
            spec = json.load(f)
    except (OSError, ValueError) as e:
        raise GraphFormatError(
            f"unreadable delta-batch file: {e}", path=path) from e
    if isinstance(spec, dict):
        spec = spec.get("deltas")
    if not isinstance(spec, list) or not spec:
        raise GraphFormatError(
            "delta-batch file must be a non-empty array of delta "
            "objects (or {\"deltas\": [...]})", path=path)
    try:
        return [DeltaBatch.from_dict(d) for d in spec]
    except GraphFormatError as e:
        raise e.with_path(path)


def summarize(sessions: List[GraphSession],
              decisions: List[dict]) -> dict:
    """The schema-v11 ``dynamic`` report section, shared by the chain
    driver and the serving layer ({'enabled': False} when nothing
    dynamic ever ran)."""
    if not sessions and not decisions:
        return {"enabled": False}
    counts = {"warm": 0, "cold": 0, "replica": 0, "escalated": 0}
    trajectory: List[Optional[int]] = []
    for d in decisions:
        mode = d.get("mode")
        if mode in counts:
            counts[mode] += 1
        if d.get("escalated"):
            counts["escalated"] += 1
        if "cut" in d:
            trajectory.append(d["cut"])
    return {
        "enabled": True,
        "sessions": [s.summary() for s in sessions],
        "decisions": list(decisions),
        "counts": {
            **counts,
            "deltas": sum(s.deltas_applied for s in sessions),
            "in_place": sum(s.in_place for s in sessions),
            "rebuilds": sum(s.rebuilds for s in sessions),
        },
        "cut_trajectory": trajectory,
    }


# ---------------------------------------------------------------------------
# chain state (the driver's own durable record; per-step compute
# checkpoints belong to the facade's manager)
# ---------------------------------------------------------------------------


def _chain_paths(checkpoint_dir: str) -> Tuple[str, str]:
    d = os.path.join(checkpoint_dir, CHAIN_STATE_DIR)
    return (os.path.join(d, CHAIN_STATE_JSON),
            os.path.join(d, CHAIN_STATE_NPZ))


def _save_chain_state(checkpoint_dir: str, session: GraphSession,
                      step: int, part_digests: List[str],
                      cuts: List[int],
                      decisions: Optional[List[dict]] = None) -> None:
    jpath, npath = _chain_paths(checkpoint_dir)
    os.makedirs(os.path.dirname(jpath), exist_ok=True)
    tmp = npath + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, partition=np.asarray(
            session.partition, dtype=np.int32))
    os.replace(tmp, npath)
    state = {
        "step": int(step),
        "chain": session.chain,
        "k": int(session.k),
        "cut": session.last_cut,
        "cuts": [int(c) for c in cuts],
        "part_digests": list(part_digests),
        # the decision rows of every COMPLETED step: a resume restores
        # them so the final report's trajectory covers the whole chain,
        # not just the recomputed tail
        "decisions": list(decisions or []),
        "counters": {
            "deltas_applied": session.deltas_applied,
            "in_place": session.in_place,
            "rebuilds": session.rebuilds,
            "repartitions": session.repartitions,
        },
    }
    tmpj = jpath + ".tmp"
    with open(tmpj, "w") as f:
        json.dump(state, f)
    os.replace(tmpj, jpath)


def _load_chain_state(checkpoint_dir: str) -> Optional[dict]:
    jpath, npath = _chain_paths(checkpoint_dir)
    try:
        with open(jpath) as f:
            state = json.load(f)
        with np.load(npath) as z:
            state["partition"] = np.asarray(
                z["partition"], dtype=np.int32)
        return state
    except (OSError, ValueError, KeyError):
        return None


def run_chain(graph, batches: List[DeltaBatch], ctx, *,
              k: int, epsilon: Optional[float] = None,
              seed: Optional[int] = None,
              session_id: str = "chain",
              quiet: bool = True,
              step_cb: Optional[Callable[[int, dict], None]] = None,
              device: DeviceLike = "cuda",
              ) -> Tuple[np.ndarray, dict]:
    """Drive register + the whole delta chain on `device`.  Returns
    (final partition, dynamic report section).  ``step_cb(step, row)``
    fires per completed step (0 = the initial register) for CLI
    printing."""
    from .. import telemetry
    from ..kaminpar import KaMinPar
    from ..utils.logger import OutputLevel

    # work on a private copy: the driver clears the resume flag after
    # the first recomputed step, and that must never leak into a
    # caller-owned context reused for another chain
    ctx = ctx.copy()
    checkpoint_dir = ctx.resilience.checkpoint_dir or ""
    resume = bool(ctx.resilience.resume) and bool(checkpoint_dir)

    session = GraphSession(session_id, graph, k=k)
    decisions: List[dict] = []
    part_digests: List[str] = []
    cuts: List[int] = []
    start_step = 0
    resumed_from: Optional[int] = None

    restored = _load_chain_state(checkpoint_dir) if resume else None
    if restored is not None and int(restored.get("k", -1)) == int(k):
        # fast-forward: re-apply the (deterministic) deltas up to the
        # recorded step, re-fold the stored repartition markers, and
        # verify the rebuilt chain hash before trusting the partition
        rec_step = int(restored["step"])
        digs = list(restored.get("part_digests") or [])
        try:
            for i in range(rec_step + 1):
                if i < len(digs):
                    if i > 0:
                        session.apply(batches[i - 1])
                    session.fold_repartition_marker(k, digs[i])
        except Exception:
            session = GraphSession(session_id, graph, k=k)
            restored = None
        if restored is not None and session.chain == restored["chain"] \
                and len(restored["partition"]) == session.graph.n:
            session.partition = restored["partition"]
            # the saved boundary is post-commit: the drift accumulators
            # were 0 there, but the replayed applies just re-filled
            # them (with no partition, ALL replayed mass counts as
            # cut-touching) — reset, or the first recomputed step's
            # drift is inflated by the whole replayed chain
            session.reset_pending_drift()
            session.last_cut = (
                None if restored.get("cut") is None
                else int(restored["cut"]))
            # the replay re-applied the deltas, but its in-place/rebuild
            # split can differ from the pre-kill truth (e.g. the
            # original run had a dynamic-apply fault plan active) — the
            # REPORTED history must be what actually happened
            counters = restored.get("counters") or {}
            session.repartitions = int(counters.get("repartitions", 0))
            session.deltas_applied = int(counters.get(
                "deltas_applied", session.deltas_applied))
            session.in_place = int(counters.get(
                "in_place", session.in_place))
            session.rebuilds = int(counters.get(
                "rebuilds", session.rebuilds))
            cuts = [int(c) for c in restored.get("cuts") or []]
            decisions = list(restored.get("decisions") or [])
            part_digests = digs
            start_step = rec_step + 1
            resumed_from = rec_step
            # note: this event is wiped by the next compute's stream
            # reset; the DURABLE record is `resumed_from_step` in the
            # returned section below
            telemetry.event(
                "dynamic", action="chain-resume", session=session_id,
                step=rec_step, chain=session.chain,
            )
        else:
            # stale/corrupt chain state: logged clean restart, exactly
            # like a checkpoint fingerprint mismatch
            from ..utils.logger import log_warning

            log_warning(
                "dynamic: chain state did not match the replayed delta "
                "chain; restarting the chain cleanly")
            session = GraphSession(session_id, graph, k=k)

    import hashlib

    def _commit_step(step: int, row: dict) -> None:
        decisions.append(row)
        cuts.append(int(row["cut"]))
        part_digests.append(hashlib.sha256(
            np.asarray(session.partition, dtype=np.int32).tobytes()
        ).hexdigest()[:16])
        if checkpoint_dir:
            _save_chain_state(
                checkpoint_dir, session, step, part_digests, cuts,
                decisions)
        if step_cb is not None:
            step_cb(step, row)

    if start_step == 0:
        # register: the base graph's initial (cold) partition — the
        # session's first gate-valid baseline.  NOT wrapped in a timer
        # scope: the facade decides stream ownership (checkpoint
        # manager, telemetry annotations, the gate verdict) by
        # GLOBAL_TIMER.idle(), and an open scope would demote the
        # register run to "nested" — unresumable and unannotated
        import time as _time

        t_reg = _time.perf_counter()
        solver = KaMinPar(ctx, device=device)
        if quiet:
            solver.set_output_level(OutputLevel.QUIET)
        solver.set_graph(session.graph)
        part = solver.compute_partition(k=k, epsilon=epsilon,
                                        seed=seed)
        reg_wall = _time.perf_counter() - t_reg
        metrics = solver.result_metrics(session.graph, part)
        gate_valid = telemetry.gate_verdict()
        session.commit_partition(
            part, int(metrics["cut"]), gate_valid=gate_valid)
        row = {
            "session": session_id, "step": 0, "mode": "cold",
            "drift": None, "cut_before": None,
            "cut": int(metrics["cut"]),
            "feasible": bool(metrics["feasible"]),
            "stable": None, "escalated": False, "seeded": 0,
            "wall_s": round(reg_wall, 4),
            "warm_wall_s": None, "cold_wall_s": round(reg_wall, 4),
        }
        if gate_valid is not None:
            row["gate_valid"] = gate_valid
        telemetry.event(
            "dynamic", action="register", session=session_id,
            n=session.graph.n, m=session.graph.m, cut=row["cut"],
        )
        _commit_step(0, row)
        start_step = 1
        # later steps must not consume this run's resume state again
        ctx.resilience.resume = False

    from ..resilience import deadline as deadline_mod

    for i, batch in enumerate(batches):
        step = i + 1
        if step < start_step:
            continue
        if deadline_mod.draining():
            # SIGTERM/drain between steps: the chain stops at a
            # committed step boundary — the state on disk resumes it
            telemetry.event(
                "dynamic", action="chain-drain", session=session_id,
                step=step,
            )
            break
        apply_info = session.apply(batch)
        outcome: RepartitionOutcome = repartition(
            session, ctx, k=k, epsilon=epsilon,
            seed=(seed + step) if seed is not None else None,
            quiet=quiet, device=device,
        )
        row = outcome.to_row(session_id, step=step)
        row["in_place"] = bool(apply_info["in_place"])
        _commit_step(step, row)
        # only the FIRST recomputed step may resume a mid-step manifest
        ctx.resilience.resume = False

    section = summarize([session], decisions)
    if resumed_from is not None:
        section["resumed_from_step"] = int(resumed_from)
    return np.asarray(session.partition), section
