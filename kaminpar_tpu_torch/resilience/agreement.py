"""Cross-rank agreement primitives and the divergence sentinels (own copy
of kaminpar_tpu/resilience/agreement.py).

Every cross-rank decision of a dist run (wind down? retry at which memory
rung? is everyone at the same pipeline stage?) shares one idiom: a small
host-side allgather over per-rank scalars, max-reduced into a verdict
every rank adopts.  :func:`agree_max` is that primitive (behind
``deadline.agreed_stop`` and ``memory.agree_rung``); :func:`maybe_audit`,
called at every checkpoint barrier of a dist run, gathers
``[stage-hash, ladder-rung, run-fingerprint-hash]`` and turns a
disagreement into a structured
:class:`~kaminpar_tpu_torch.resilience.errors.RankDivergence` with a
per-rank dump.

Rank model: this package drives all shards from one process, which is
rank 0 of 1.  Two override layers, the JAX package's, exist for tests and
smokes: ``KAMINPAR_TPU_SIM_RANK`` / ``KAMINPAR_TPU_SIM_RANKS`` (pretend to
be rank K of N: rank-scoped fault addressing, ``site@rank=K``) and
:func:`set_gather_override` (replace the gather, to present a divergent
or N-rank fleet without spawning processes).  Everything here is host
numpy; with one process and no override every gather is the local row.
"""

from __future__ import annotations

import hashlib
import os
from typing import Callable, List, Optional, Tuple

import numpy as np

from . import runstate

#: Simulation overrides (tests / single-process chaos smokes): pretend
#: to be rank SIM_RANK of SIM_RANKS.  They scope fault addressing and
#: the report's rank stamp; they do NOT spawn processes or change what
#: the real collectives do.
ENV_SIM_RANK = "KAMINPAR_TPU_SIM_RANK"
ENV_SIM_RANKS = "KAMINPAR_TPU_SIM_RANKS"

#: Test hook: replaces the cross-process allgather.  Signature
#: ``f(local_row: np.ndarray[int64]) -> np.ndarray[num_ranks, len]``;
#: install with :func:`set_gather_override`, clear with None.
_gather_override: Optional[Callable[[np.ndarray], np.ndarray]] = None


def set_gather_override(
    fn: Optional[Callable[[np.ndarray], np.ndarray]]
) -> None:
    """Install (or with None clear) the allgather test hook — lets a
    single-process test present a divergent or N-rank fleet to the
    sentinel/agreement layer."""
    global _gather_override
    _gather_override = fn


def process_index() -> int:
    """This process's index among the run's processes: 0, since one
    process drives every shard of the mesh (parallel/mesh.py)."""
    return 0


def process_count() -> int:
    """The run's process count: 1 (see :func:`process_index`)."""
    return 1


def rank() -> int:
    """This process's rank: the SIM override when set, else its
    :func:`process_index`."""
    raw = os.environ.get(ENV_SIM_RANK, "")
    if raw:
        try:
            return int(raw)
        except ValueError:
            pass
    return process_index()


def num_ranks() -> int:
    """Fleet size: the SIM override when set, else the process count."""
    raw = os.environ.get(ENV_SIM_RANKS, "")
    if raw:
        try:
            return max(1, int(raw))
        except ValueError:
            pass
    return process_count()


def gather_i64(row) -> np.ndarray:
    """Allgather one small int64 row: returns ``[ranks, len(row)]`` — the
    test override when installed, else the local row alone (one
    process)."""
    local = np.asarray(row, dtype=np.int64).reshape(-1)
    if _gather_override is not None:
        out = np.asarray(_gather_override(local), dtype=np.int64)
        return out.reshape(-1, local.shape[0])
    return local[None, :]


def agree_max(value: int) -> Tuple[int, int]:
    """The allgather-max agreement: every rank contributes ``value`` and
    adopts the fleet maximum.  Returns ``(agreed, triggering_rank)`` —
    the rank whose contribution WAS the maximum (lowest such rank), so
    degradations can name who pulled the fleet down.  Single rank: the
    identity."""
    rows = gather_i64([int(value)])
    vec = rows[:, 0]
    trig = int(np.argmax(vec))
    return int(vec.max()), trig


# ---------------------------------------------------------------------------
# divergence sentinels
# ---------------------------------------------------------------------------


class AuditState:
    """One dist run's sentinel state (held on the thread-local RunState,
    armed only by the stream-owning dist driver)."""

    __slots__ = ("scheme", "fp_hash", "audits", "stage", "divergence")

    def __init__(self, scheme: str, fp_hash: int) -> None:
        self.scheme = scheme
        self.fp_hash = fp_hash
        self.audits = 0
        self.stage = ""
        self.divergence: Optional[dict] = None


def _hash63(text: str) -> int:
    """Stable non-negative 63-bit hash (int64-safe for the gather)."""
    digest = hashlib.sha256(text.encode()).digest()
    return int.from_bytes(digest[:8], "big") & 0x7FFFFFFFFFFFFFFF


def arm(scheme: str, graph_fp: str, ctx_fp: str,
        shard_fps: List[str]) -> AuditState:
    """Arm the divergence sentinels for the calling thread's run (dist
    facade entry): every subsequent checkpoint barrier audits the fleet
    until :func:`disarm`.  The three fingerprints fold into ONE hash —
    ranks running a different graph, config, or sharding plan disagree
    on it at the first barrier."""
    st = AuditState(
        scheme, _hash63(f"{graph_fp}|{ctx_fp}|{'|'.join(shard_fps)}")
    )
    runstate.current().dist = st
    return st


def disarm() -> None:
    runstate.current().dist = None


def state() -> Optional[AuditState]:
    return getattr(runstate.current(), "dist", None)


def maybe_audit(stage_id: str) -> None:
    """The barrier piggyback: a no-op (one attribute read) unless the
    dist driver armed the sentinels; armed, one small allgather of
    ``[stage-hash, rung, fingerprint-hash]`` and an exact comparison.
    Divergence raises :class:`RankDivergence` with the per-rank dump —
    annotated into the run report FIRST, so the dump survives into the
    emergency report of the run the raise unwinds."""
    st = state()
    if st is None:
        return
    from .errors import RankDivergence
    from .faults import maybe_inject

    # chaos site: an injected rank-divergence exercises the abort path
    # without needing a genuinely skewed fleet
    maybe_inject("rank-divergence")
    from . import memory as memory_mod

    mem = memory_mod.state()
    rung = int(mem.rung) if mem is not None else 0
    local = [_hash63(stage_id), rung, st.fp_hash]
    rows = gather_i64(local)
    st.stage = stage_id
    if bool((rows == rows[0]).all()):
        st.audits += 1
        return
    dump = [
        {
            "rank": r,
            "stage_hash": int(rows[r, 0]),
            "rung": int(rows[r, 1]),
            "fingerprint_hash": int(rows[r, 2]),
            # only the local rank knows its stage STRING; peers are
            # identified by hash (enough to see who skewed where)
            **({"stage": stage_id} if r == rank() else {}),
        }
        for r in range(rows.shape[0])
    ]
    fields = []
    if not bool((rows[:, 0] == rows[0, 0]).all()):
        fields.append("stage")
    if not bool((rows[:, 1] == rows[0, 1]).all()):
        fields.append("rung")
    if not bool((rows[:, 2] == rows[0, 2]).all()):
        fields.append("fingerprint")
    st.divergence = {
        "barrier": stage_id,
        "fields": fields,
        "ranks": dump,
    }
    from .. import telemetry
    from ..utils.logger import log_warning

    telemetry.event(
        "rank-divergence", barrier=stage_id, fields=fields,
        ranks=len(dump),
    )
    # stamp the dump NOW: the raise below unwinds past the facade's
    # success-path annotations, and the per-rank dump is exactly what a
    # post-crash report must carry
    telemetry.annotate(dist_resilience=section())
    log_warning(
        f"rank divergence at barrier {stage_id}: ranks disagree on "
        f"{'/'.join(fields)} — aborting with the per-rank dump"
    )
    raise RankDivergence(
        f"ranks diverged at barrier {stage_id} on {'/'.join(fields)}: "
        f"{dump}",
        ranks=dump,
        site="rank-divergence",
    )


def section() -> dict:
    """The run report's ``dist_resilience`` sentinel half (the dist
    driver merges in resume/ladder details).  ``{'enabled': False}``
    when no dist run armed the sentinels on this thread."""
    st = state()
    if st is None:
        return {"enabled": False}
    d = {
        "enabled": True,
        "ranks": num_ranks(),
        "rank": rank(),
        "audits": int(st.audits),
        "last_stage": st.stage,
    }
    if st.divergence is not None:
        d["divergence"] = st.divergence
    return d
