"""Preemption-safe checkpoint/resume at the multilevel pipeline barriers
(own copy of kaminpar_tpu/resilience/checkpoint.py; manifests and
snapshots of either package read in the other).

At each barrier — after each coarsening level's contraction, after
initial partitioning, after each uncoarsening level's refinement, after
each v-cycle and streamed level, and the facade's final ``result`` — the
driver offers its state to the manager here, which writes it atomically
(io/snapshot.py) under ``ctx.resilience.checkpoint_dir``, rotates a
versioned manifest, prunes superseded snapshots and emits a
``checkpoint`` telemetry event with the bytes and wall it cost.  A
payload is a zero-argument callable: a run without a manager builds
nothing and reads nothing off the device; with one, each barrier copies
its level to the host once.

``ctx.resilience.resume`` validates the manifest (graph and context
fingerprints; a :class:`CheckpointMismatch` degrades to a clean restart)
and the driver re-enters at the recorded stage.  Degradation sites:
``checkpoint-write`` (a failed write degrades to in-memory-only
checkpoints) and ``checkpoint-load`` (a corrupt snapshot falls back to
the previous manifest generation).  An unusable directory disables
checkpointing with a warning.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from .errors import CheckpointCorrupt, CheckpointMismatch, CheckpointWriteFailed

MANIFEST = "manifest.json"
MANIFEST_PREV = "manifest.prev.json"
MANIFEST_VERSION = 1

#: Debug/test hook: ``KAMINPAR_TPU_STOP_AT=stage[:level]`` requests the
#: graceful deadline wind-down the first time that barrier is crossed —
#: a deterministic stand-in for "preemption notice received here".  A
#: trailing ``!`` (``uncoarsen:2!``) instead simulates a HARD kill:
#: :class:`SimulatedPreemption` is raised right after the barrier's
#: checkpoint lands, as if the process died there — the kill-and-resume
#: equivalence suite drives every barrier kind through both modes.
STOP_AT_ENV = "KAMINPAR_TPU_STOP_AT"


class SimulatedPreemption(RuntimeError):
    """Raised by the STOP_AT test hook's hard mode.  Deliberately NOT a
    DegradationError: like a real SIGKILL it must never be swallowed by
    a fallback policy."""

# The active manager and the nested-run suspend counter live on the
# per-run (thread-local) RunState — see resilience/runstate.py.  The
# function API below is unchanged; back-to-back and interleaved runs
# (the serving layer's request stream) each see only their own state.
from . import runstate


def activate(mgr: Optional["CheckpointManager"]) -> None:
    """Install the run's manager (facade entry; None deactivates).  Only
    the run that owns the telemetry stream activates one — nested runs
    (shm IP inside the dist driver) see no manager, so a checkpoint can
    never record an inner pipeline's stage as the outer run's."""
    runstate.current().manager = mgr


def deactivate() -> None:
    run = runstate.current()
    run.manager = None
    run.suspend = 0


def active() -> Optional["CheckpointManager"]:
    return runstate.current().manager


def suspend() -> None:
    """Blind the barrier hook for the duration of a NESTED pipeline run
    (shm IP inside the dist driver): the inner drivers call barrier()
    like any other, but must neither rewrite the outer run's manifest
    with their own scheme/stage nor consume its resume state.  The
    facade suspends around nested (non-stream-owning) runs and
    unsuspends in its finally; re-entrant (counted)."""
    runstate.current().suspend += 1


def unsuspend() -> None:
    run = runstate.current()
    run.suspend = max(0, run.suspend - 1)


def suspended() -> bool:
    return runstate.current().suspend > 0


def create_manager(res_ctx, graph, ctx) -> Optional["CheckpointManager"]:
    """The facades' shared arm-and-maybe-resume step (shm and dist must
    not drift apart on this policy): build the manager from the
    resilience context, and on `resume` load + validate the recorded
    state — a CheckpointMismatch/CheckpointCorrupt degrades to a logged
    clean restart, never a crash.  Returns None when checkpointing is
    not configured.  The caller still activates it (and only when it
    owns the telemetry stream)."""
    if not res_ctx.checkpoint_dir:
        return None
    mgr = CheckpointManager(
        res_ctx.checkpoint_dir, graph_fingerprint(graph), ctx_fingerprint(ctx)
    )
    if res_ctx.resume and mgr.enabled:
        from .. import telemetry
        from ..utils.logger import log_warning

        try:
            mgr.load_resume_state()
        except (CheckpointMismatch, CheckpointCorrupt) as e:
            log_warning(
                f"--resume: {type(e).__name__}: {e}; starting a clean run"
            )
            telemetry.event(
                "checkpoint", action="clean-restart",
                error=f"{type(e).__name__}: {e}"[:300],
            )
    return mgr


def barrier(
    stage: str,
    level: Optional[int] = None,
    scheme: str = "",
    payload: Optional[Callable[[], dict]] = None,
    keep: Optional[List[str]] = None,
    meta: Optional[dict] = None,
    agree: bool = False,
) -> bool:
    """The single driver hook at every pipeline barrier.

    Notes the stage for the anytime annotation, offers a checkpoint when
    a manager is active (``payload`` is a zero-arg callable returning
    ``{snapshot_name: {array_name: ndarray}}`` so disabled runs build
    nothing and pull nothing off device), honors the STOP_AT test hook,
    and returns False once the deadline wind-down has begun — callers
    stop starting new *optional* work on False (mandatory tail work —
    projection, extension, balance — ignores the verdict).
    ``agree=True`` makes the verdict cross-rank consistent
    (deadline.agreed_stop), for gated work that contains collectives.
    A dist run's divergence sentinels audit every barrier first
    (agreement.maybe_audit; one attribute read otherwise).
    """
    from . import deadline

    run = runstate.current()
    stage_id = stage if level is None else f"{stage}:{int(level)}"
    if not run.suspend:
        # nested (suspended) runs neither track stages nor checkpoint —
        # but they DO honor the wind-down verdict below
        deadline.note_stage(stage_id)
        from . import agreement

        agreement.maybe_audit(stage_id)
        mgr = run.manager
        if mgr is not None and mgr.enabled:
            # build the payload only while persistence has not degraded
            # to memory-only
            new = (
                payload()
                if (payload is not None and not mgr.memory_only)
                else {}
            )
            mgr.offer(
                stage, level=level, scheme=scheme,
                new=new, keep=keep or [], meta=meta or {},
            )
        # memory-governor pressure hook (resilience/memory.py): AFTER
        # the checkpoint offer (the newest level must be serialized
        # before its siblings may be spilled); two attribute reads while
        # the governor is dormant
        from . import memory as memory_mod

        memory_mod.on_barrier(stage_id)
        # liveness heartbeat (resilience/supervisor.py): barrier
        # crossings are the pipeline's proof of progress; one attribute
        # read when no heartbeat file is configured
        from . import supervisor as supervisor_mod

        supervisor_mod.heartbeat_touch()
        stop_at = os.environ.get(STOP_AT_ENV, "")
        if stop_at:
            hard = stop_at.endswith("!")
            target = stop_at.rstrip("!")
            if target in (stage, stage_id):
                if hard:
                    raise SimulatedPreemption(
                        f"simulated hard preemption at barrier {stage_id}"
                    )
                deadline.request_stop(f"stop-at:{stage_id}")
    if agree:
        return not deadline.agreed_stop()
    return not deadline.should_stop()


def take_resume(scheme: str) -> Optional[dict]:
    """Hand the pending resume state to the driver whose scheme matches
    (consumed on first take, so a clean-restart re-dispatch cannot
    accidentally resume twice).  Suspended (nested) runs never see it —
    an inner IP replica must not restore the outer run's state."""
    run = runstate.current()
    if run.manager is None or run.suspend:
        return None
    return run.manager.take_resume(scheme)


# ---------------------------------------------------------------------------
# fingerprints
# ---------------------------------------------------------------------------


def graph_fingerprint(graph) -> str:
    """Cheap, stable identity of the input graph: sizes, weight totals,
    and boundary samples of the adjacency — O(1)-ish even for TeraPart
    inputs (never a full-graph hash), but enough that resuming against a
    different graph is practically impossible to miss."""
    # a dynamic graph session stamps an evolving fingerprint onto the
    # graph object (the JAX package's dynamic/session.py)
    session_fp = getattr(graph, "_session_fp", None)
    if session_fp is not None:
        return str(session_fp)
    h = hashlib.sha256()
    n, m = int(graph.n), int(graph.m)
    h.update(f"n={n};m={m};".encode())
    try:
        nw = np.asarray(graph.node_weight_array(), dtype=np.int64)
        h.update(str(int(nw.sum())).encode())
        h.update(nw[:1024].tobytes())
    except Exception:
        pass
    from ..graphs.compressed import CompressedHostGraph

    if isinstance(graph, CompressedHostGraph):
        xr, adj, _ = graph.decode_range(0, min(n, 2048))
        h.update(np.asarray(xr, dtype=np.int64).tobytes())
        h.update(np.asarray(adj, dtype=np.int64)[:4096].tobytes())
    elif not hasattr(graph, "adjncy"):
        # generator-spec wrapper (external/chunkstore.StreamedSpecGraph):
        # the spec string + degree prefix IS the graph's identity — the
        # adjacency is deterministic from them and never materialized
        h.update(str(getattr(graph, "spec", "")).encode())
        xadj = np.asarray(graph.xadj, dtype=np.int64)
        h.update(xadj[:2048].tobytes())
        h.update(xadj[-2048:].tobytes())
    else:
        xadj = np.asarray(graph.xadj, dtype=np.int64)
        h.update(xadj[:2048].tobytes())
        h.update(xadj[-2048:].tobytes())
        adj = np.asarray(graph.adjncy)
        h.update(adj[:4096].tobytes())
        h.update(adj[-4096:].tobytes())
    return h.hexdigest()[:24]


def ctx_fingerprint(ctx) -> str:
    """Identity of the algorithmic configuration a checkpoint is valid
    for: the full context tree minus the subtrees that may legitimately
    differ between the interrupted and the resuming invocation (the
    resilience knobs themselves — `--resume` flips one — and debug
    dumps).  Seed, k, epsilon, preset, and every algorithm knob are in."""
    from ..context import context_to_dict

    d = context_to_dict(ctx)
    d.pop("resilience", None)
    d.pop("debug", None)
    shm = d.get("shm")  # a DistContext nests the shm tree
    if isinstance(shm, dict):
        shm.pop("resilience", None)
        shm.pop("debug", None)
    blob = json.dumps(d, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:24]


# ---------------------------------------------------------------------------
# the manager
# ---------------------------------------------------------------------------


class CheckpointManager:
    """One run's checkpoint state: versioned manifest + named snapshots.

    Snapshot files are immutable and generation-suffixed
    (``<name>-g<G>.npz``); each ``offer`` writes only the *new* snapshots
    for its barrier and carries forward the ``keep`` set by reference, so
    a hierarchy level is serialized exactly once.  The manifest is
    rotated (current -> ``manifest.prev.json``) before the new one is
    written, which is what the corrupted-load fallback and a
    kill-between-renames both recover from.  Files referenced by neither
    manifest are pruned."""

    def __init__(self, directory: str, graph_fp: str, ctx_fp: str):
        self.dir = directory
        self.graph_fp = graph_fp
        self.ctx_fp = ctx_fp
        self.enabled = True
        # set when a write failed (checkpoint-write degrade): offers are
        # still tracked — stats, events, stage bookkeeping — but nothing
        # further is persisted and payloads are no longer even built
        # (the barrier hook skips them)
        self.memory_only = False
        self.generation = 0
        self._snapshots: Dict[str, dict] = {}  # name -> manifest entry
        # pinned snapshot names are carried forward by EVERY offer, on
        # top of the offering driver's own keep list — the external
        # scheme pins its streamed-level projection maps so the in-core
        # deep phase's barriers (which know nothing about them) cannot
        # prune them out of the manifest
        self._pinned: set = set()
        self._resume: Optional[dict] = None
        self._resume_taken = False
        self.stats = {"writes": 0, "bytes": 0, "wall_s": 0.0}
        self._probe_dir()

    # -- setup ----------------------------------------------------------

    def _probe_dir(self) -> None:
        """Unusable checkpoint dir degrades with a warning (the
        native-cache-dir fallback pattern), never an exception."""
        from .. import telemetry
        from ..utils.logger import log_warning

        try:
            os.makedirs(self.dir, exist_ok=True)
            probe = os.path.join(self.dir, f".probe-{os.getpid()}")
            with open(probe, "w") as f:
                f.write("ok")
            os.remove(probe)
        except OSError as e:
            self.enabled = False
            log_warning(
                f"checkpoint dir {self.dir!r} unusable ({e}); "
                "checkpointing DISABLED for this run"
            )
            telemetry.event(
                "checkpoint", action="dir-unusable", dir=self.dir,
                error=str(e)[:200],
            )

    # -- write path -----------------------------------------------------

    def offer(
        self,
        stage: str,
        level: Optional[int],
        scheme: str,
        new: Dict[str, Dict[str, np.ndarray]],
        keep: List[str],
        meta: dict,
    ) -> None:
        """Record one barrier: write new snapshots, carry the keep set
        forward, rotate the manifest, prune."""
        if not self.enabled:
            return
        from .. import telemetry

        t0 = time.perf_counter()
        self.generation += 1
        gen = self.generation
        entries: Dict[str, dict] = {}
        for name in list(keep) + sorted(self._pinned):
            ent = self._snapshots.get(name)
            if ent is not None:
                entries[name] = ent
        wrote_bytes = 0
        for name, arrays in new.items():
            ent = self._write_snapshot(name, gen, arrays)
            entries[name] = ent
            if not ent.get("memory"):
                wrote_bytes += int(ent["bytes"])
        self._snapshots = entries
        manifest = {
            "version": MANIFEST_VERSION,
            "generation": gen,
            "graph_fingerprint": self.graph_fp,
            "ctx_fingerprint": self.ctx_fp,
            "scheme": scheme,
            "stage": stage,
            "level": level,
            "meta": meta,
            "snapshots": {
                k: v for k, v in entries.items() if not v.get("memory")
            },
        }
        if not self.memory_only:
            self._write_manifest(manifest)
            self._prune()
        wall = time.perf_counter() - t0
        self.stats["writes"] += 1
        self.stats["bytes"] += wrote_bytes
        self.stats["wall_s"] += wall
        telemetry.event(
            "checkpoint",
            stage=stage,
            level=level,
            scheme=scheme,
            generation=gen,
            bytes=wrote_bytes,
            wall_s=round(wall, 4),
            memory_only=self.memory_only,
        )

    def _write_snapshot(self, name: str, gen: int, arrays: dict) -> dict:
        """One snapshot through the ``checkpoint-write`` degradation
        site: filesystem failure (or an injected fault) flips the run to
        in-memory-only mode instead of killing it."""
        from ..io.snapshot import write_snapshot
        from .policy import with_fallback

        fname = f"{name}-g{gen}.npz"
        path = os.path.join(self.dir, fname)
        if self.memory_only:
            return {"file": fname, "memory": True}

        def primary():
            try:
                return write_snapshot(path, arrays)
            except OSError as e:
                raise CheckpointWriteFailed(
                    f"snapshot write failed: {path}: {e}"
                ) from e

        def fallback(exc):
            self.memory_only = True
            return None

        written = with_fallback(
            primary, fallback, site="checkpoint-write", where=name,
        )
        if written is None:
            return {"file": fname, "memory": True}
        nbytes, sha = written
        return {"file": fname, "sha256": sha, "bytes": int(nbytes)}

    def _write_manifest(self, manifest: dict) -> None:
        from .policy import with_fallback

        cur = os.path.join(self.dir, MANIFEST)
        prev = os.path.join(self.dir, MANIFEST_PREV)

        def primary():
            try:
                if os.path.exists(cur):
                    os.replace(cur, prev)
                tmp = cur + f".tmp{os.getpid()}"
                with open(tmp, "w") as f:
                    json.dump(manifest, f, indent=1)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, cur)
                from ..io.snapshot import _fsync_dir

                _fsync_dir(self.dir)
                return True
            except OSError as e:
                raise CheckpointWriteFailed(
                    f"manifest write failed: {e}"
                ) from e

        def fallback(exc):
            self.memory_only = True
            return None

        with_fallback(primary, fallback, site="checkpoint-write",
                      where="manifest")

    def _prune(self) -> None:
        """Remove snapshot files referenced by neither the current nor
        the previous manifest (superseded levels, old state files)."""
        referenced = set()
        for mf in (MANIFEST, MANIFEST_PREV):
            try:
                with open(os.path.join(self.dir, mf)) as f:
                    man = json.load(f)
                for ent in man.get("snapshots", {}).values():
                    referenced.add(ent["file"])
            except (OSError, ValueError, KeyError, TypeError):
                continue
        try:
            names = os.listdir(self.dir)
        except OSError:
            return
        for fn in names:
            if not fn.endswith(".npz") or fn in referenced:
                continue
            try:
                os.unlink(os.path.join(self.dir, fn))
            except OSError:
                pass

    # -- load path ------------------------------------------------------

    def load_resume_state(self) -> Optional[dict]:
        """Validate and load the recorded stage for --resume.

        Returns None when the directory holds no checkpoint (a fresh
        start, not an error).  Raises CheckpointMismatch when the
        manifest belongs to a different graph/context (callers degrade
        to a clean restart) and CheckpointCorrupt when both manifest
        generations are unreadable.  A corrupted *snapshot* under the
        newest manifest engages the ``checkpoint-load`` site and falls
        back to the previous generation."""
        from .policy import with_fallback

        cur = os.path.join(self.dir, MANIFEST)
        prev = os.path.join(self.dir, MANIFEST_PREV)
        if not os.path.exists(cur) and not os.path.exists(prev):
            return None

        def load_current():
            return self._load_generation(cur)

        def load_previous(exc):
            if isinstance(exc, CheckpointMismatch):
                raise exc  # a mismatch is semantic; prev matches no better
            if not os.path.exists(prev):
                raise exc if exc is not None else CheckpointCorrupt(
                    "no previous manifest generation to fall back to"
                )
            return self._load_generation(prev)

        state = with_fallback(
            load_current, load_previous, site="checkpoint-load",
        )
        self._resume = state
        self._resume_taken = False
        # continue the generation numbering and snapshot refs of the
        # loaded manifest so the resumed run's keep-lists resolve
        self.generation = int(state["generation"])
        self._snapshots = dict(state["snapshot_entries"])
        from .. import telemetry

        telemetry.event(
            "checkpoint",
            action="resumed",
            stage=state["stage"],
            level=state["level"],
            scheme=state["scheme"],
            generation=self.generation,
        )
        return state

    def _load_generation(self, manifest_path: str) -> dict:
        try:
            with open(manifest_path) as f:
                man = json.load(f)
        except (OSError, ValueError) as e:
            raise CheckpointCorrupt(
                f"manifest unreadable: {manifest_path}: {e}"
            ) from e
        if not isinstance(man, dict) or man.get("version") != MANIFEST_VERSION:
            raise CheckpointCorrupt(
                f"manifest version mismatch in {manifest_path}: "
                f"{man.get('version') if isinstance(man, dict) else man!r}"
            )
        if man.get("graph_fingerprint") != self.graph_fp:
            raise CheckpointMismatch(
                "checkpoint belongs to a different graph "
                f"(manifest {man.get('graph_fingerprint')!r}, "
                f"current {self.graph_fp!r})"
            )
        if man.get("ctx_fingerprint") != self.ctx_fp:
            raise CheckpointMismatch(
                "checkpoint belongs to a different configuration "
                f"(manifest {man.get('ctx_fingerprint')!r}, "
                f"current {self.ctx_fp!r})"
            )
        from ..io.snapshot import SnapshotError, read_snapshot

        arrays: Dict[str, Dict[str, np.ndarray]] = {}
        for name, ent in man.get("snapshots", {}).items():
            path = os.path.join(self.dir, ent["file"])
            try:
                arrays[name] = read_snapshot(path, ent.get("sha256"))
            except (OSError, SnapshotError) as e:
                raise CheckpointCorrupt(str(e)) from e
        return {
            "scheme": man.get("scheme", ""),
            "stage": man["stage"],
            "level": man.get("level"),
            "meta": man.get("meta", {}),
            "arrays": arrays,
            "generation": int(man.get("generation", 0)),
            "snapshot_entries": dict(man.get("snapshots", {})),
        }

    def pin(self, names) -> None:
        """Mark snapshots as carried forward by every future offer (on
        top of each offer's own keep list).  Used by the external
        scheme: streamed-level projection maps must survive the in-core
        phase's barriers, whose keep lists don't know about them."""
        self._pinned.update(names)

    def pending_resume(self) -> Optional[dict]:
        """The loaded-but-unconsumed resume state (None once taken) —
        lets a driver VALIDATE driver-specific preconditions (the dist
        shard-fingerprint vector) before any scheme dispatch consumes
        it."""
        if self._resume is None or self._resume_taken:
            return None
        return self._resume

    def drop_resume(self, reason: str) -> None:
        """Discard the pending resume state: a driver-level mismatch (a
        resume under another shard count, seen through the shard
        fingerprints) degrades to a logged clean restart."""
        if self._resume is None:
            return
        from .. import telemetry
        from ..utils.logger import log_warning

        log_warning(f"--resume: {reason}; starting a clean run")
        telemetry.event(
            "checkpoint", action="clean-restart", error=reason[:300],
        )
        self._resume = None
        self._resume_taken = False

    def take_resume(self, scheme: str) -> Optional[dict]:
        if (
            self._resume is None
            or self._resume_taken
            or self._resume.get("scheme") != scheme
        ):
            return None
        self._resume_taken = True
        return self._resume

    def take_result_resume(self) -> Optional[np.ndarray]:
        """The final-partition fast path: a run preempted *after* the
        output gate left a `result` stage; resuming returns it without
        re-partitioning."""
        if self._resume is None or self._resume_taken:
            return None
        if self._resume.get("stage") != "result":
            return None
        state = self._resume.get("arrays", {}).get("state")
        if state is None or "partition" not in state:
            return None
        self._resume_taken = True
        return np.asarray(state["partition"], dtype=np.int32)

    # -- reporting ------------------------------------------------------

    def resumed_from(self) -> Optional[str]:
        """The stage this run ACTUALLY resumed from — gated on the state
        having been consumed by a driver, so a loaded-but-unused resume
        (e.g. a dist mid-pipeline stage the dist driver cannot re-enter)
        is not reported as a resume that happened."""
        if self._resume is None or not self._resume_taken:
            return None
        lvl = self._resume.get("level")
        return (
            f"{self._resume['stage']}"
            + ("" if lvl is None else f":{int(lvl)}")
        )

    def summary(self) -> dict:
        """The run report's `checkpoint` section.  `resumed_from` is
        omitted (not null) for non-resumed runs so the schema can type
        it as a plain string."""
        d = {
            "enabled": self.enabled,
            "dir": self.dir,
            "memory_only": self.memory_only,
            "generation": self.generation,
            "writes": int(self.stats["writes"]),
            "bytes": int(self.stats["bytes"]),
            "wall_s": round(float(self.stats["wall_s"]), 4),
            "snapshots": sorted(self._snapshots),
        }
        if self.resumed_from() is not None:
            d["resumed_from"] = self.resumed_from()
        return d
