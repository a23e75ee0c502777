"""Fault-site registry and the ``KAMINPAR_TPU_FAULTS`` injection harness
(own copy of kaminpar_tpu/resilience/faults.py: the same sites, plan
grammar and seeded draws, so one plan string fires at the same
invocation counts in both packages).

Every optional fast path that can degrade registers a *site*: a stable
name, the structured exception its failures surface as, and a one-line
description of the fallback.  Sites this package never reaches (serving,
workers, dynamic sessions, distributed runs, ``lane-gather``) stay
registered so that a plan parses in both packages.

    KAMINPAR_TPU_FAULTS=site[@rank=K][:spec][,site[@rank=K][:spec]...]

``site`` is a registered name or ``all`` (the degradation-contract sites
only: the corruption-chaos sites ``bit-flip:*``, ``spill-corrupt``,
``cache-poison`` and ``worker-reply-corrupt`` must be named); ``spec``
is omitted or ``always`` (every call fails), ``nth=K`` (exactly the K-th
call, 1-based) or a probability in (0, 1], drawn from a hash of the run
seed, the site and the per-site call counter.  ``@rank=K`` scopes a rule
to process rank K; this package runs one process, of rank 0 unless
``KAMINPAR_TPU_SIM_RANK`` says otherwise.  Dormant (two dict lookups)
when the variable is unset.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Type

from ..utils import rng as rng_mod
from .errors import (
    AdmissionRejected,
    CacheDegraded,
    CheckpointCorrupt,
    CheckpointWriteFailed,
    CollectiveTimeout,
    DegradationError,
    DeltaApplyFailed,
    DeviceOOM,
    IntegrityViolation,
    NativeUnavailable,
    PlanBlowup,
    RankDivergence,
    RefinerRefused,
    StageHang,
    WorkerCrash,
)

#: Impersonate another process rank in rank-scoped plans (the variable
#: the JAX package's resilience/agreement.py reads).
ENV_SIM_RANK = "KAMINPAR_TPU_SIM_RANK"


def _rank() -> int:
    raw = os.environ.get(ENV_SIM_RANK, "")
    if raw:
        try:
            return int(raw)
        except ValueError:
            pass
    return 0


ENV_VAR = "KAMINPAR_TPU_FAULTS"


@dataclass(frozen=True)
class SiteSpec:
    """One registered degradation site (a row of the degradation matrix)."""

    name: str
    exc: Type[DegradationError]
    fallback: str  # human-readable fallback description (docs + events)
    description: str


# Registered in the JAX package's order, with its names and texts;
# with_fallback() rejects names not listed here.
SITES: Dict[str, SiteSpec] = {}


def _register(spec: SiteSpec) -> None:
    SITES[spec.name] = spec


_register(SiteSpec(
    "native-build", NativeUnavailable,
    "ctypes-free mode (numpy codecs, python parsers)",
    "g++ build / dlopen of the native library (native/__init__.py)",
))
_register(SiteSpec(
    "native-ip", NativeUnavailable,
    "pure-numpy multilevel bipartitioner",
    "native sequential initial bipartitioner (initial/bipartitioner.py)",
))
_register(SiteSpec(
    "native-fm", RefinerRefused,
    "numpy FM pass (or unchanged partition on refusal)",
    "native localized batch k-way FM (refinement/fm.py)",
))
_register(SiteSpec(
    "refiner", DeviceOOM,
    "rollback to the pre-step partition (best known)",
    "one refinement algorithm step (partitioning/refiner.py)",
))
_register(SiteSpec(
    "device-balancer", DeviceOOM,
    "exact greedy host balancer",
    "device overload-balancing rounds (ops/balancer.py)",
))
_register(SiteSpec(
    "lane-gather", PlanBlowup,
    "plain XLA gather (no routed plan for the level)",
    "routed lane-gather plan build (ops/lane_gather.py)",
))
_register(SiteSpec(
    "compressed-stream", DeviceOOM,
    "decode to uncompressed host CSR and re-partition",
    "chunk-streamed device upload of a compressed graph (graphs/csr.py)",
))
_register(SiteSpec(
    "collective", CollectiveTimeout,
    "local-only data (skip cross-process aggregation)",
    "host-side cross-process gathers (telemetry/report.py, dist driver)",
))
_register(SiteSpec(
    "checkpoint-write", CheckpointWriteFailed,
    "in-memory-only checkpoints (run continues, durability lost)",
    "atomic snapshot/manifest write at a pipeline barrier "
    "(resilience/checkpoint.py)",
))
_register(SiteSpec(
    "checkpoint-load", CheckpointCorrupt,
    "previous manifest generation (one barrier of progress lost)",
    "snapshot read + checksum validation on --resume "
    "(resilience/checkpoint.py)",
))
_register(SiteSpec(
    "serving-admit", AdmissionRejected,
    "structured `rejected` verdict for that request (service keeps "
    "serving)",
    "serving-layer request admission (serving/service.py)",
))
_register(SiteSpec(
    "serving-cache", CacheDegraded,
    "forced miss/evict: the request recomputes (correctness untouched)",
    "serving-layer result-cache lookup (serving/service.py)",
))
_register(SiteSpec(
    "device-oom", DeviceOOM,
    "memory-governor recovery ladder: retry at the next rung "
    "(tight pads -> spilled hierarchy -> semi-external -> host-only; "
    "dist runs agree the rung across ranks first)",
    "allocator-shaped OOM at device upload / contraction / refinement "
    "(resilience/memory.py ladder; ladder-retryable OOMs never latch "
    "the serving per-class breaker — only rung exhaustion does)",
))
_register(SiteSpec(
    "worker-hang", StageHang,
    "supervisor SIGKILLs the worker past its hard ceiling; the request "
    "fails with verdict `failed`/reason `worker-hang`, the service "
    "keeps draining the queue",
    "supervised worker wall-clock containment (resilience/supervisor.py; "
    "chaos: the child worker genuinely sleeps past the ceiling and the "
    "supervisor's kill path is what is exercised)",
))
_register(SiteSpec(
    "worker-crash", WorkerCrash,
    "worker death is detected, classified, and answered with verdict "
    "`failed`/reason `worker-crash`; a fresh worker serves the next "
    "request",
    "supervised worker crash containment (resilience/supervisor.py; "
    "chaos: the child worker exits via SIGKILL — the native-segfault "
    "stand-in)",
))
_register(SiteSpec(
    "dynamic-apply", DeltaApplyFailed,
    "full CSR rebuild + re-upload into a fresh bucket for that delta "
    "(the bucket-crossing path; strictly more work, never a wrong "
    "graph)",
    "in-place CSR delta application of a dynamic graph session "
    "(dynamic/session.py; deltas that fit the padded bucket's slack "
    "reuse the compiled executables)",
))
# corruption-chaos sites (resilience/integrity.py): injection here does
# NOT raise at the site — the integrity chaos helpers catch the injected
# IntegrityViolation and genuinely mutate bytes in flight, so the
# DETECTORS (sentinels / digests) are what the chaos suite exercises
_register(SiteSpec(
    "bit-flip:contraction", IntegrityViolation,
    "none at the site — the flipped projection-map bit is DETECTED by "
    "the contraction sentinels (edge-weight conservation / cmap range) "
    "and recovered by one retry from the last clean barrier",
    "silent bit-flip in a contraction's projection map "
    "(partitioning/coarsener.py; chaos mutates a cmap entry in flight)",
))
_register(SiteSpec(
    "bit-flip:partition", IntegrityViolation,
    "none at the site — the corrupted partition entry is DETECTED by "
    "the refinement sentinels (partition-range) and recovered by one "
    "retry from the last clean barrier",
    "silent bit-flip in a refined partition vector "
    "(partitioning/refiner.py; chaos mutates a partition entry)",
))
_register(SiteSpec(
    "spill-corrupt", IntegrityViolation,
    "digest mismatch on re-read -> drop the spill file, re-decode the "
    "chunk from its source, rewrite (local recovery; never garbage rows)",
    "chunkstore spill-tier file corruption "
    "(external/chunkstore.py; chaos flips a byte in the spilled file)",
))
_register(SiteSpec(
    "cache-poison", IntegrityViolation,
    "digest mismatch on hit -> forced miss + evict; the request "
    "recomputes (a poisoned entry is never served)",
    "serving result-cache entry corruption "
    "(serving/service.py; chaos flips a bit in the cached partition)",
))
_register(SiteSpec(
    "worker-reply-corrupt", IntegrityViolation,
    "reply digest mismatch -> classified IntegrityViolation for that "
    "request (verdict `failed`/reason `corrupt-result`); the worker "
    "keeps serving",
    "supervised-worker npz reply corruption "
    "(resilience/supervisor.py; chaos flips a byte in the reply file)",
))
_register(SiteSpec(
    "rank-divergence", RankDivergence,
    "none — structured abort with the per-rank state dump (divergence "
    "has no safe local fallback)",
    "cross-rank divergence sentinel at the dist pipeline barriers "
    "(resilience/agreement.py audit)",
))


@dataclass
class _FaultRule:
    site: str  # registered name or "all"
    prob: Optional[float] = None  # None => deterministic (always / nth)
    nth: Optional[int] = None  # 1-based exact call index
    rank: Optional[int] = None  # None => every rank; K => rank K only


@dataclass
class _PlanState:
    raw: str
    rules: List[_FaultRule] = field(default_factory=list)


_plan_cache: Optional[_PlanState] = None
_counters: Dict[str, int] = {}
_injected: List[dict] = []


class FaultPlanError(ValueError):
    """KAMINPAR_TPU_FAULTS could not be parsed (bad site or spec)."""


def parse_plan(raw: str) -> List[_FaultRule]:
    """Parse a fault-plan string; raises FaultPlanError on bad input."""
    rules: List[_FaultRule] = []
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        site, _, spec = part.partition(":")
        site = site.strip()
        # rank scoping: `site@rank=K` restricts the rule to process
        # rank K (the single-sick-rank chaos address)
        rank: Optional[int] = None
        if "@" in site:
            site, _, rank_spec = site.partition("@")
            site = site.strip()
            rank_spec = rank_spec.strip()
            if not rank_spec.startswith("rank="):
                raise FaultPlanError(
                    f"bad rank scope {rank_spec!r} in {part!r} "
                    "(want site@rank=K)"
                )
            try:
                rank = int(rank_spec[5:])
            except ValueError:
                raise FaultPlanError(
                    f"bad rank number in {part!r} (want site@rank=K)"
                )
            if rank < 0:
                raise FaultPlanError(f"rank must be >= 0 in {part!r}")
        if site not in SITES and site != "all":
            # colon-named sites (`bit-flip:contraction`): the first-colon
            # split above took the site's own second segment as the spec
            # — rejoin it when that yields a registered name, leaving the
            # remainder (if any) as the real spec
            head, _, rest = spec.partition(":")
            cand = f"{site}:{head.strip()}"
            if cand in SITES:
                site, spec = cand, rest
        if site != "all" and site not in SITES:
            raise FaultPlanError(
                f"unknown fault site {site!r} (registered: "
                f"{', '.join(SITES)}, or 'all')"
            )
        spec = spec.strip()
        if not spec or spec == "always":
            rules.append(_FaultRule(site, rank=rank))
        elif spec.startswith("nth="):
            try:
                nth = int(spec[4:])
            except ValueError:
                raise FaultPlanError(f"bad nth spec {spec!r} for {site!r}")
            if nth < 1:
                raise FaultPlanError(f"nth must be >= 1 in {part!r}")
            rules.append(_FaultRule(site, nth=nth, rank=rank))
        else:
            try:
                prob = float(spec)
            except ValueError:
                raise FaultPlanError(
                    f"bad fault spec {spec!r} for {site!r} "
                    "(want nothing, 'always', 'nth=K', or a probability)"
                )
            if not 0.0 < prob <= 1.0:
                raise FaultPlanError(f"probability out of (0, 1] in {part!r}")
            rules.append(_FaultRule(site, prob=prob, rank=rank))
    return rules


def _active_plan() -> Optional[_PlanState]:
    """The parsed plan for the CURRENT env value (re-parsed on change)."""
    global _plan_cache
    raw = os.environ.get(ENV_VAR, "")
    if not raw:
        _plan_cache = None
        return None
    if _plan_cache is None or _plan_cache.raw != raw:
        _plan_cache = _PlanState(raw=raw, rules=parse_plan(raw))
    return _plan_cache


def _seeded_draw(site: str, count: int) -> float:
    """Deterministic uniform [0, 1) draw keyed by (seed, site, count)."""
    seed = rng_mod.get_seed()
    digest = hashlib.sha256(f"{seed}:{site}:{count}".encode()).digest()
    return int.from_bytes(digest[:8], "big") / float(1 << 64)


def maybe_inject(site: str, **attrs) -> None:
    """Raise the site's structured exception if the active fault plan says
    this call fails.  Called by with_fallback at every site entry (and by
    a few deep injection points inside primaries).  No-op without a plan.
    """
    spec = SITES[site]  # KeyError = unregistered site, a programming error
    plan = _active_plan()
    if plan is None:
        return
    count = _counters.get(site, 0) + 1
    _counters[site] = count
    fire = False
    local_rank: Optional[int] = None
    for rule in plan.rules:
        if rule.site != "all" and rule.site != site:
            continue
        if rule.site == "all" and issubclass(spec.exc, IntegrityViolation):
            # `all` plans cover the degradation contract; corruption
            # chaos is opt-in by name (see module docstring) — two
            # corruption sites firing in one run would exhaust the
            # bounded retry ladder by construction, not by bug
            continue
        if rule.rank is not None:
            if local_rank is None:
                local_rank = _rank()
            if rule.rank != local_rank:
                continue  # scoped to a different rank: rule inert here
        if rule.nth is not None:
            fire = count == rule.nth
        elif rule.prob is not None:
            fire = _seeded_draw(site, count) < rule.prob
        else:
            fire = True
        if fire:
            break
    if not fire:
        return
    entry = {"site": site, "call": count}
    if rule.rank is not None:
        # a rank-scoped rule fired: record WHERE (unscoped entries keep
        # their historical two-key shape)
        entry["rank"] = int(rule.rank)
    _injected.append(entry)
    raise spec.exc(
        f"injected fault at site '{site}' (call #{count}, "
        f"{ENV_VAR}={plan.raw})",
        site=site,
        injected=True,
    )


def site_spec(site: str) -> SiteSpec:
    """The SiteSpec for a registered name; KeyError on unknown sites."""
    return SITES[site]


def injected_log() -> List[dict]:
    """All faults fired so far ({site, call} dicts, in firing order)."""
    return list(_injected)


def reset() -> None:
    """Clear counters and the fired-fault log (test isolation)."""
    global _plan_cache
    _counters.clear()
    _injected.clear()
    _plan_cache = None


def plan_summary() -> dict:
    """The run report's fault-plan echo: the raw plan (or None), the
    registered site list, and every fault fired so far."""
    raw = os.environ.get(ENV_VAR, "") or None
    return {
        "plan": raw,
        "sites": list(SITES),
        "injected": injected_log(),
    }
