"""Silent-data-corruption defense: invariant sentinels, content digests,
sampled re-execution audits and the corruption-chaos helpers (own copy of
kaminpar_tpu/resilience/integrity.py, less the worker and cache
boundaries this package does not have).

  * **sentinels** at the phase boundaries: node and edge weight
    conservation across each contraction, the cluster map's range and
    surjectivity, coarse-CSR symmetry; the partition's range ``[0, k)``
    and cut non-increase across each accepted refinement pass.  Each is
    a small torch reduction of its own, on the graph's device, with one
    readback per check; a failure raises a structured
    :class:`~.errors.IntegrityViolation`, which ``with_fallback`` never
    absorbs and :func:`run_with_retry` answers with one re-execution
    from the last clean checkpoint barrier;
  * **digests**: sha256 content digests on the external chunk store's
    spill files (a mismatch re-decodes the chunk);
  * **audits**: ``KAMINPAR_TPU_AUDIT_FRACTION`` re-runs a deterministic
    sample of device reductions on the host and compares bitwise;
  * **chaos**: the ``bit-flip:*`` and ``spill-corrupt`` fault sites
    mutate bytes in flight, so the detectors are exercised end to end.

``KAMINPAR_TPU_INTEGRITY=0`` is the kill switch (sentinels, digests and
audits dormant; chaos still mutates).
"""

from __future__ import annotations

import hashlib
import os
import time
from typing import Any, Callable, Dict, Optional, TypeVar

import numpy as np
import torch

from ..dtypes import ACC_DTYPE
from .errors import IntegrityViolation

ENV_INTEGRITY = "KAMINPAR_TPU_INTEGRITY"
ENV_AUDIT_FRACTION = "KAMINPAR_TPU_AUDIT_FRACTION"

#: Bounded retry ladder: how many re-executions from the last clean
#: barrier one run gets before the verdict is ``corrupt-result``.
MAX_RETRIES = 1

T = TypeVar("T")

# ---------------------------------------------------------------------------
# module state (host-side; reset() for test isolation)
# ---------------------------------------------------------------------------

_stats: Dict[str, Any] = {
    "checks": 0,
    "violations": [],  # [{invariant, level, scope, site, detail}]
    "retries": 0,
    "recovered": 0,
    "verdict": None,  # None | "recovered" | "corrupt-result"
    "wall_s": 0.0,
}
_digests: Dict[str, int] = {"computed": 0, "verified": 0, "mismatched": 0}
_audits: Dict[str, Dict[str, int]] = {}  # scope -> {audited, mismatched}
_audit_counts: Dict[str, int] = {}  # scope -> sampling call counter


def enabled() -> bool:
    """Sentinels/digests/audits run unless KAMINPAR_TPU_INTEGRITY=0."""
    return os.environ.get(ENV_INTEGRITY, "") != "0"


def audit_fraction() -> float:
    """The sampled re-execution audit fraction (0 = audits off)."""
    raw = os.environ.get(ENV_AUDIT_FRACTION, "").strip()
    if not raw:
        return 0.0
    try:
        val = float(raw)
    except ValueError:
        return 0.0
    return min(max(val, 0.0), 1.0)


def reset() -> None:
    """Clear counters, violations and audits (test isolation)."""
    _stats.update(
        checks=0, violations=[], retries=0, recovered=0, verdict=None,
        wall_s=0.0,
    )
    _digests.update(computed=0, verified=0, mismatched=0)
    _audits.clear()
    _audit_counts.clear()


class _timed:
    """Accumulate sentinel wall time (the ``integrity_overhead_pct``
    numerator): every host-side check body runs under one of these."""

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _stats["wall_s"] += time.perf_counter() - self._t0
        return False


# ---------------------------------------------------------------------------
# violations
# ---------------------------------------------------------------------------


def _record_violation(
    invariant: str, detail: str, *, level: Optional[int], scope: str,
    site: str,
) -> None:
    _stats["violations"].append({
        "invariant": invariant,
        "level": level,
        "scope": scope,
        "site": site,
        "detail": detail[:300],
    })
    from .. import telemetry
    from ..utils.logger import log_warning

    telemetry.event(
        "integrity", action="violation", invariant=invariant,
        level=level, scope=scope, site=site or None,
        detail=detail[:300],
    )
    log_warning(
        f"INTEGRITY violation [{invariant}"
        + (f"@level{level}" if level is not None else "")
        + f"] at {scope or '?'}: {detail[:160]}"
    )


def violation(
    invariant: str, detail: str, *, level: Optional[int] = None,
    scope: str = "", site: str = "",
) -> IntegrityViolation:
    """Record + build (the caller raises) a structured violation."""
    _record_violation(invariant, detail, level=level, scope=scope,
                      site=site)
    return IntegrityViolation(
        f"integrity violation [{invariant}] at {scope or '?'}: {detail}",
        invariant=invariant, level=level, scope_path=scope,
        site=site or None,
    )


def check(
    invariant: str, ok: bool, detail: str, *, level: Optional[int] = None,
    scope: str = "",
) -> None:
    """One sentinel predicate: counts, and raises on failure."""
    _stats["checks"] += 1
    if not ok:
        raise violation(invariant, detail, level=level, scope=scope)


# ---------------------------------------------------------------------------
# invariant sentinels (small torch reductions of their own, one readback
# per check)
# ---------------------------------------------------------------------------


def _contraction_scalars(fine_graph, cmap, coarse_graph):
    acc = ACC_DTYPE
    # pad nodes and edges carry weight 0, so unmasked sums are exact
    fine_nw = fine_graph.node_w.sum(dtype=acc)
    coarse_nw = coarse_graph.node_w.sum(dtype=acc)
    # every fine edge between two clusters lands in exactly one coarse
    # (directed) edge; contraction sums parallels and drops self-loops
    n_pad_c = coarse_graph.node_w.shape[0]
    cm = cmap.clamp(0, n_pad_c - 1).to(torch.int64)
    cross = torch.where(cm[fine_graph.src.to(torch.int64)]
                        != cm[fine_graph.dst.to(torch.int64)],
                        fine_graph.edge_w.to(acc), 0).sum(dtype=acc)
    coarse_ew = coarse_graph.edge_w.sum(dtype=acc)
    n_pad_f = cmap.shape[0]
    dev = cmap.device
    real_f = torch.arange(n_pad_f, device=dev) < fine_graph.n
    cmap_min = torch.where(real_f, cmap, 0).min().to(acc)
    cmap_max = torch.where(real_f, cmap, 0).max().to(acc)
    hit = torch.zeros(n_pad_c, dtype=torch.int32, device=dev)
    hit.scatter_reduce_(0, cm, real_f.to(torch.int32), "amax")
    real_c = torch.arange(n_pad_c, device=dev) < coarse_graph.n
    distinct = torch.where(real_c, hit, 0).sum(dtype=acc)
    # CSR symmetry necessary conditions on the coarse graph: equal
    # directed weight both ways, zero self-loop weight
    w = coarse_graph.edge_w.to(acc)
    fwd = torch.where(coarse_graph.src < coarse_graph.dst, w, 0).sum(
        dtype=acc)
    bwd = torch.where(coarse_graph.src > coarse_graph.dst, w, 0).sum(
        dtype=acc)
    loops = torch.where(coarse_graph.src == coarse_graph.dst, w, 0).sum(
        dtype=acc)
    return torch.stack([fine_nw, coarse_nw, cross, coarse_ew, cmap_min,
                        cmap_max, distinct, fwd, bwd, loops])


def check_contraction(
    fine_graph, cmap, coarse_graph, *, level: int, fine_n: int,
    coarse_n: int,
) -> None:
    """Contraction sentinels at the coarsening phase boundary: one
    reduction of ten scalars, compared on the host.  Conservation is
    level-local (fine vs coarse sums of the same level), so weight that
    preprocessing legitimately drops never trips it.  No-op when
    integrity is disabled."""
    if not enabled():
        return
    with _timed():
        (fine_nw, coarse_nw, cross, coarse_ew, cmap_min, cmap_max,
         distinct, fwd, bwd, loops) = (int(v) for v in _contraction_scalars(
             fine_graph, cmap, coarse_graph).tolist())
        scope = f"coarsen:{level}"
        check(
            "node-weight-conservation",
            coarse_nw == fine_nw,
            f"coarse node-weight sum {coarse_nw} != fine {fine_nw}",
            level=level, scope=scope,
        )
        check(
            "edge-weight-conservation",
            cross == coarse_ew,
            f"fine cross-cluster edge weight {cross} != coarse edge "
            f"weight {coarse_ew}",
            level=level, scope=scope,
        )
        check(
            "cmap-range",
            0 <= cmap_min and cmap_max < coarse_n,
            f"cmap range [{cmap_min}, {cmap_max}] outside "
            f"[0, {coarse_n})",
            level=level, scope=scope,
        )
        check(
            "cmap-surjective",
            distinct == coarse_n,
            f"{distinct} distinct coarse ids hit, expected {coarse_n}",
            level=level, scope=scope,
        )
        check(
            "coarse-csr-symmetry",
            fwd == bwd and loops == 0,
            f"directed weight {fwd} vs {bwd}, self-loop weight {loops}",
            level=level, scope=scope,
        )
    # sampled audit: the coarse node weights recomputed on the host from
    # the fine weights and the projection map, compared bitwise
    if should_audit("contraction-weights"):
        with _timed():
            nw = fine_graph.node_w[:fine_n].cpu().numpy().astype(np.int64)
            cm = cmap[:fine_n].cpu().numpy().astype(np.int64)
            host_bw = np.bincount(
                np.clip(cm, 0, max(coarse_n - 1, 0)), weights=nw,
                minlength=coarse_n,
            ).astype(np.int64)
            dev_bw = coarse_graph.node_w[:coarse_n].cpu().numpy().astype(
                np.int64)
            record_audit(
                "contraction-weights",
                mismatched=not np.array_equal(host_bw, dev_bw),
                level=level,
            )


def refine_probe(graph, partition, max_block_weights, min_block_weights):
    """(cut, feasible, part_min, part_max) for the refinement sentinels:
    one reduction, host ints out.  None when integrity is disabled."""
    if not enabled():
        return None
    from ..ops import metrics

    with _timed():
        cut = metrics.edge_cut(graph, partition).to(ACC_DTYPE)
        feas = metrics.is_feasible(graph, partition, max_block_weights,
                                   min_block_weights).to(ACC_DTYPE)
        real = torch.arange(partition.shape[0],
                            device=partition.device) < graph.n
        pmin = torch.where(real, partition, 0).min().to(ACC_DTYPE)
        pmax = torch.where(real, partition, 0).max().to(ACC_DTYPE)
        cut, feas, pmin, pmax = torch.stack([cut, feas, pmin,
                                             pmax]).tolist()
    return int(cut), bool(feas), int(pmin), int(pmax)


def check_refinement(before, after, *, k: int, level: int) -> None:
    """Refinement sentinels across one accepted refine pass: partition
    range ``[0, k)`` and cut non-increase, the latter only for a
    feasible -> feasible pass (a balancer may trade cut for balance).
    ``before``/``after`` are :func:`refine_probe` tuples (None: no-op)."""
    if before is None or after is None:
        return
    with _timed():
        cut_b, feas_b, _, _ = before
        cut_a, feas_a, pmin, pmax = after
        scope = f"refine:{level}"
        check(
            "partition-range",
            0 <= pmin and pmax < k,
            f"partition range [{pmin}, {pmax}] outside [0, {k})",
            level=level, scope=scope,
        )
        check(
            "cut-non-increase",
            not (feas_b and feas_a and cut_a > cut_b),
            f"accepted refinement pass raised the cut {cut_b} -> {cut_a} "
            "on a feasible partition",
            level=level, scope=scope,
        )


def audit_refine_cut(graph, partition, device_cut: int, *,
                     level: int) -> None:
    """Sampled host re-execution of one cut evaluation, compared with the
    device value bitwise."""
    if not enabled() or not should_audit("refine-cut"):
        return
    with _timed():
        from ..graphs.csr import host_graph_from_device

        host = host_graph_from_device(graph)
        part = partition[: host.n].cpu().numpy()
        xadj = np.asarray(host.xadj, dtype=np.int64)
        owner = np.repeat(np.arange(host.n, dtype=np.int64), np.diff(xadj))
        crosses = part[owner] != part[np.asarray(host.adjncy)]
        ew = np.asarray(host.edge_weight_array(), dtype=np.int64)
        host_cut = int(ew[crosses].sum()) // 2
        record_audit(
            "refine-cut", mismatched=host_cut != int(device_cut),
            level=level,
            detail=f"host {host_cut} vs device {int(device_cut)}",
        )


# ---------------------------------------------------------------------------
# sampled audits
# ---------------------------------------------------------------------------


def should_audit(scope: str) -> bool:
    """Deterministic per-scope sampling at KAMINPAR_TPU_AUDIT_FRACTION:
    the draw is keyed by (seed, scope, call index), so reruns audit the
    same calls (the faults.py determinism contract)."""
    frac = audit_fraction()
    if frac <= 0.0 or not enabled():
        return False
    count = _audit_counts.get(scope, 0) + 1
    _audit_counts[scope] = count
    if frac >= 1.0:
        return True
    from ..utils import rng as rng_mod

    seed = rng_mod.get_seed()
    digest = hashlib.sha256(
        f"audit:{seed}:{scope}:{count}".encode()
    ).digest()
    return int.from_bytes(digest[:8], "big") / float(1 << 64) < frac


def record_audit(scope: str, *, mismatched: bool,
                 level: Optional[int] = None, detail: str = "") -> None:
    """Count one audited re-execution; a bitwise mismatch is a
    violation (raised) on top of the per-scope tally."""
    ent = _audits.setdefault(scope, {"audited": 0, "mismatched": 0})
    ent["audited"] += 1
    if mismatched:
        ent["mismatched"] += 1
        raise violation(
            f"audit:{scope}",
            detail or "host re-execution disagreed with the device "
                      "value bitwise",
            level=level, scope=f"audit:{scope}",
        )


# ---------------------------------------------------------------------------
# exchange digests
# ---------------------------------------------------------------------------


def content_digest(*arrays) -> str:
    """sha256 hex over the raw bytes of the given numpy arrays (shape
    and dtype folded in, so a reinterpretation cannot collide)."""
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(f"{a.dtype.str}:{a.shape};".encode())
        h.update(a.tobytes())
    _digests["computed"] += 1
    return h.hexdigest()


def verify_digest(expected: str, *arrays, what: str = "",
                  site: str = "") -> None:
    """Recompute and compare a content digest; mismatch raises a
    classified IntegrityViolation (invariant ``exchange-digest``).
    A missing expected digest verifies vacuously (pre-upgrade data)."""
    if not expected or not enabled():
        return
    with _timed():
        actual = content_digest(*arrays)
        _digests["computed"] -= 1  # verification, not a new stamp
        _digests["verified"] += 1
        if actual != expected:
            _digests["mismatched"] += 1
            raise violation(
                "exchange-digest",
                f"{what or 'payload'}: digest {actual[:16]}... != "
                f"expected {expected[:16]}...",
                scope=what, site=site,
            )


def note_digest_mismatch(what: str, detail: str, *,
                         site: str = "") -> IntegrityViolation:
    """Record an externally detected digest mismatch (io/snapshot.py's
    SnapshotError path) as a classified violation; returns the exception
    for the caller to raise or recover from."""
    _digests["verified"] += 1
    _digests["mismatched"] += 1
    return violation("exchange-digest", f"{what}: {detail}",
                     scope=what, site=site)


# ---------------------------------------------------------------------------
# corruption chaos (faults.py sites; mutation is genuine)
# ---------------------------------------------------------------------------


def chaos_flip_array(site: str, arr: np.ndarray, *,
                     bit: int = 7) -> np.ndarray:
    """Injection hook for in-flight array corruption: when the fault
    plan fires at ``site``, return a copy with one bit of element 0
    flipped (a genuine mutation — the DETECTORS are what chaos tests);
    otherwise return ``arr`` unchanged.  Never raises."""
    from . import faults

    try:
        faults.maybe_inject(site)
    except IntegrityViolation:
        out = np.array(arr, copy=True)
        flat = out.reshape(-1)
        flat[0] = flat[0] ^ type(flat[0])(1 << bit)
        from .. import telemetry

        telemetry.event(
            "integrity", action="chaos-corrupt", site=site,
            kind="array", bit=bit,
        )
        return out
    return arr


def chaos_corrupt_contraction(coarse):
    """``bit-flip:contraction`` chaos: when the fault plan fires, flip bit
    5 of the first coarse edge-weight slot.  The edge-weight conservation
    and CSR-symmetry sentinels are what detect it."""
    from . import faults

    try:
        faults.maybe_inject("bit-flip:contraction")
    except IntegrityViolation:
        import dataclasses

        ew = coarse.graph.edge_w.clone()
        ew[0] ^= 1 << 5
        graph = dataclasses.replace(coarse.graph, edge_w=ew)
        from .. import telemetry

        telemetry.event(
            "integrity", action="chaos-corrupt",
            site="bit-flip:contraction", kind="edge-weight", bit=5,
        )
        return dataclasses.replace(coarse, graph=graph)
    return coarse


def chaos_corrupt_partition(partition):
    """``bit-flip:partition`` chaos: when the fault plan fires, flip bit
    20 of the first partition label, far outside any ``[0, k)`` bucket, so
    the partition-range sentinel fires before the output gate could
    repair it."""
    from . import faults

    try:
        faults.maybe_inject("bit-flip:partition")
    except IntegrityViolation:
        part = partition.clone()
        part[0] ^= 1 << 20
        from .. import telemetry

        telemetry.event(
            "integrity", action="chaos-corrupt",
            site="bit-flip:partition", kind="partition", bit=20,
        )
        return part
    return partition


def chaos_flip_file(site: str, path: str) -> bool:
    """Injection hook for at-rest byte corruption: when the fault plan
    fires at ``site``, flip one bit of the middle byte of ``path`` in
    place.  Returns True when the file was mutated."""
    from . import faults

    try:
        faults.maybe_inject(site)
    except IntegrityViolation:
        try:
            size = os.path.getsize(path)
            if size <= 0:
                return False
            with open(path, "r+b") as f:
                f.seek(size // 2)
                b = f.read(1)
                f.seek(size // 2)
                f.write(bytes([b[0] ^ 0x40]))
            from .. import telemetry

            telemetry.event(
                "integrity", action="chaos-corrupt", site=site,
                kind="file", path=os.path.basename(path),
            )
            return True
        except OSError:
            return False
    return False


# ---------------------------------------------------------------------------
# the retry-from-last-good-barrier ladder
# ---------------------------------------------------------------------------


def run_with_retry(body: Callable[[], T], *, where: str = "") -> T:
    """Run the pipeline body under the bounded corruption-recovery
    ladder: on the first IntegrityViolation, reload the last clean
    checkpoint barrier (the sentinel fired BEFORE its level's barrier,
    so the newest manifest is by construction pre-corruption) and
    re-execute once; a second violation is the ``corrupt-result``
    verdict and propagates.  Fault counters are deliberately NOT reset,
    so a deterministic ``nth=K`` injection does not re-fire — the
    retried run is clean and (deterministic seeds) cut-identical to an
    uninjected one."""
    if not enabled():
        return body()
    last: Optional[IntegrityViolation] = None
    for attempt in range(MAX_RETRIES + 1):
        try:
            result = body()
        except IntegrityViolation as exc:
            last = exc
            if attempt >= MAX_RETRIES:
                break
            _stats["retries"] += 1
            resumed = _reload_last_barrier()
            try:
                from .. import telemetry

                telemetry.event(
                    "integrity", action="retry",
                    invariant=exc.invariant, level=exc.level,
                    scope=exc.scope_path, where=where or None,
                    resumed_from=resumed,
                )
            except Exception:
                pass
            try:
                from ..utils.logger import log_warning

                log_warning(
                    f"integrity: retrying from "
                    f"{resumed or 'scratch'} after violation "
                    f"[{exc.invariant}]"
                )
            except Exception:
                pass
            continue
        if attempt and last is not None:
            _stats["recovered"] += 1
            _stats["verdict"] = "recovered"
            try:
                from .. import telemetry

                telemetry.event(
                    "integrity", action="recovered",
                    invariant=last.invariant, level=last.level,
                    where=where or None,
                )
            except Exception:
                pass
        return result
    assert last is not None
    _stats["verdict"] = "corrupt-result"
    try:
        from .. import telemetry

        telemetry.event(
            "integrity", action="corrupt-result",
            invariant=last.invariant, level=last.level,
            where=where or None,
        )
    except Exception:
        pass
    raise last


def _reload_last_barrier() -> Optional[str]:
    """Re-arm the run's checkpoint resume state from the last persisted
    manifest (the last clean barrier).  Returns the stage id the retry
    will resume from, or None (no manager / no checkpoint: the retry
    re-executes from scratch, which IS the last clean barrier then)."""
    from . import runstate

    mgr = runstate.current().manager
    if mgr is None or not mgr.enabled or mgr.memory_only:
        return None
    try:
        state = mgr.load_resume_state()
    except Exception:
        return None
    if state is None:
        return None
    lvl = state.get("level")
    return (
        str(state.get("stage", ""))
        + ("" if lvl is None else f":{int(lvl)}")
    )


# ---------------------------------------------------------------------------
# report surface (schema v14 `integrity` section)
# ---------------------------------------------------------------------------


def summary() -> Dict[str, Any]:
    """The run report's ``integrity`` section.  The well-formed
    disabled default when the kill switch is set and nothing ran."""
    active = (
        enabled()
        or _stats["checks"] > 0
        or bool(_stats["violations"])
        or _digests["verified"] > 0
    )
    if not active:
        return {"enabled": False}
    clean = not _stats["violations"]
    return {
        "enabled": bool(enabled()),
        "checks": int(_stats["checks"]),
        "violations": [dict(v) for v in _stats["violations"]],
        "retries": int(_stats["retries"]),
        "recovered": int(_stats["recovered"]),
        "verdict": (
            _stats["verdict"] if _stats["verdict"] is not None
            else ("clean" if clean else "detected")
        ),
        "digests": dict(_digests),
        "audits": {k: dict(v) for k, v in sorted(_audits.items())},
        "audit_fraction": audit_fraction(),
        "wall_s": round(float(_stats["wall_s"]), 6),
    }


def overhead_pct(total_wall_s: float) -> float:
    """Sentinel wall time as a percentage of a run's total wall (the
    bench's always-present ``integrity_overhead_pct`` key)."""
    total = float(total_wall_s)
    if total <= 0:
        return 0.0
    return round(100.0 * float(_stats["wall_s"]) / total, 3)
