"""Graph sessions and delta ingestion (own copy of
kaminpar_tpu/dynamic/session.py).

A :class:`GraphSession` owns a mutable host graph, its last gate-valid
partition and an evolving identity: the base graph's sampling
``graph_fingerprint`` plus a running delta-chain hash.  Every applied
:class:`DeltaBatch` and every committed repartition folds its own digest
into the chain, so checkpoints key on the exact chain position without
re-hashing the adjacency per mutate: the chain digest is stamped onto the
session's graph object, where ``caching.full_graph_digest`` and
``checkpoint.graph_fingerprint`` read it back.  The ``dyn:`` prefix keeps
chain digests apart from the digests of plain graphs.  The batches, the
patched graphs and every digest are the JAX package's, byte for byte.

A delta whose patched (n, m) stays inside the current padded bucket
(``caching.bucket_key``) commits in place; a bucket-crossing delta is a
rebuild (the device epoch is bumped).  The in-place commit runs under the
registered ``dynamic-apply`` degradation site: an injected or classified
failure falls back to the rebuild path, never to a wrong graph.

Malformed deltas raise ``io.GraphFormatError`` (out-of-range endpoints,
self loops, duplicate inserts, deleting or re-weighting a missing edge,
non-positive weights), like a malformed graph file.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from .. import caching
from ..graphs.host import HostGraph, from_edge_list
from ..io.errors import GraphFormatError


def _as_pairs(a, what: str) -> np.ndarray:
    if a is None:
        return np.zeros((0, 2), dtype=np.int64)
    arr = np.asarray(a, dtype=np.int64)
    if arr.size == 0:
        return np.zeros((0, 2), dtype=np.int64)
    if arr.ndim != 2 or arr.shape[1] != 2:
        raise GraphFormatError(f"{what} must be an (e, 2) pair array")
    return arr


def _as_ids(a) -> np.ndarray:
    if a is None:
        return np.zeros(0, dtype=np.int64)
    return np.asarray(a, dtype=np.int64).reshape(-1)


@dataclass
class DeltaBatch:
    """One atomic mutation of a session graph.

    Application order within a batch: vertex adds (new ids are appended
    at ``n`` .. ``n + vertex_adds - 1`` and may be referenced by the
    edge operations of the *same* batch) -> edge deletes -> edge weight
    updates -> node weight updates -> edge inserts -> vertex removes
    (surviving nodes are compacted, ids above a removed id shift down).
    Pairs are undirected (both CSR directions are patched)."""

    #: (e, 2) undirected pairs to insert (must not already exist).
    edge_inserts: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 2), dtype=np.int64))
    #: per-insert weights (None = unit).
    insert_weights: Optional[np.ndarray] = None
    #: (e, 2) undirected pairs to delete (must exist).
    edge_deletes: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 2), dtype=np.int64))
    #: (e, 2) undirected pairs whose weight changes (must exist) ...
    edge_weight_updates: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 2), dtype=np.int64))
    #: ... to these weights.
    update_weights: Optional[np.ndarray] = None
    #: number of new vertices appended (isolated unless edges of this
    #: batch reference them).
    vertex_adds: int = 0
    #: weights of the added vertices (None = unit).
    add_weights: Optional[np.ndarray] = None
    #: vertex ids to remove (incident edges are deleted, survivors
    #: compacted).
    vertex_removes: np.ndarray = field(
        default_factory=lambda: np.zeros(0, dtype=np.int64))
    #: (i, 2) rows of (vertex id, new weight).
    node_weight_updates: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 2), dtype=np.int64))

    def __post_init__(self) -> None:
        self.edge_inserts = _as_pairs(self.edge_inserts, "edge_inserts")
        self.edge_deletes = _as_pairs(self.edge_deletes, "edge_deletes")
        self.edge_weight_updates = _as_pairs(
            self.edge_weight_updates, "edge_weight_updates")
        self.vertex_removes = _as_ids(self.vertex_removes)
        self.node_weight_updates = _as_pairs(
            self.node_weight_updates, "node_weight_updates")
        self.vertex_adds = int(self.vertex_adds)
        if self.vertex_adds < 0:
            raise GraphFormatError("vertex_adds must be >= 0")
        if self.insert_weights is not None:
            self.insert_weights = _as_ids(self.insert_weights)
            if len(self.insert_weights) != len(self.edge_inserts):
                raise GraphFormatError(
                    "insert_weights length != edge_inserts length")
        if self.update_weights is None and len(self.edge_weight_updates):
            raise GraphFormatError(
                "edge_weight_updates requires update_weights")
        if self.update_weights is not None:
            self.update_weights = _as_ids(self.update_weights)
            if len(self.update_weights) != len(self.edge_weight_updates):
                raise GraphFormatError(
                    "update_weights length != edge_weight_updates length")
        if self.add_weights is not None:
            self.add_weights = _as_ids(self.add_weights)
            if len(self.add_weights) != self.vertex_adds:
                raise GraphFormatError(
                    "add_weights length != vertex_adds")

    @property
    def empty(self) -> bool:
        return not (
            len(self.edge_inserts) or len(self.edge_deletes)
            or len(self.edge_weight_updates) or self.vertex_adds
            or len(self.vertex_removes) or len(self.node_weight_updates)
        )

    @classmethod
    def from_dict(cls, d: dict) -> "DeltaBatch":
        """Parse the JSON wire form (``--delta-batch`` files, serving
        ``delta`` request fields).  Unknown keys are format errors."""
        if not isinstance(d, dict):
            raise GraphFormatError("delta must be a JSON object")
        known = {
            "edge_inserts", "insert_weights", "edge_deletes",
            "edge_weight_updates", "update_weights", "vertex_adds",
            "add_weights", "vertex_removes", "node_weight_updates",
        }
        unknown = sorted(set(d) - known)
        if unknown:
            raise GraphFormatError(f"unknown delta key(s): {unknown}")
        try:
            return cls(**{k: d[k] for k in known if k in d})
        except (TypeError, ValueError) as e:
            if isinstance(e, GraphFormatError):
                raise
            raise GraphFormatError(f"malformed delta: {e}") from e

    def to_dict(self) -> dict:
        out: Dict[str, object] = {}
        for key in ("edge_inserts", "edge_deletes", "edge_weight_updates",
                    "vertex_removes", "node_weight_updates"):
            arr = getattr(self, key)
            if len(arr):
                out[key] = np.asarray(arr).tolist()
        for key in ("insert_weights", "update_weights", "add_weights"):
            arr = getattr(self, key)
            if arr is not None and len(arr):
                out[key] = np.asarray(arr).tolist()
        if self.vertex_adds:
            out["vertex_adds"] = int(self.vertex_adds)
        return out

    def digest(self) -> str:
        """Content hash of the batch — the token folded into the
        session's delta-chain hash (one sweep over the DELTA arrays,
        never the full adjacency)."""
        h = hashlib.sha256()
        for key in ("edge_inserts", "insert_weights", "edge_deletes",
                    "edge_weight_updates", "update_weights",
                    "add_weights", "vertex_removes",
                    "node_weight_updates"):
            arr = getattr(self, key)
            h.update(key.encode())
            if arr is None:
                h.update(b"\x00none")
            else:
                h.update(np.ascontiguousarray(
                    np.asarray(arr, dtype=np.int64)).tobytes())
        h.update(f"adds={self.vertex_adds}".encode())
        return h.hexdigest()[:24]


@dataclass
class _Patched:
    """A patch result, computed pure before either commit path runs."""

    graph: HostGraph
    partition: Optional[np.ndarray]  # -1 marks unseeded new vertices
    bucket: tuple
    delta_mass: int
    cut_touch_mass: int
    new_unseeded: int


def chain_digest(parent: str, token: str) -> str:
    """One link of the delta-chain hash: H(parent, token)."""
    return hashlib.sha256(f"{parent}:{token}".encode()).hexdigest()[:24]


class GraphSession:
    """A mutable graph + its partition + its evolving identity."""

    def __init__(self, session_id: str, graph: HostGraph, k: int = 2,
                 validate: bool = False) -> None:
        from ..graphs.host import validate as validate_graph
        from ..resilience.checkpoint import graph_fingerprint

        if not isinstance(graph, HostGraph):
            raise GraphFormatError(
                "dynamic sessions need a plain host CSR graph "
                f"(got {type(graph).__name__}); compressed containers "
                "and streamed specs have no patchable adjacency"
            )
        if validate:
            validate_graph(graph)
        # the session takes OWNERSHIP of the graph object (deltas
        # mutate it); a stale identity stamp from a previous session
        # over the same object must not leak into this session's base
        # identity — strip before hashing
        for attr in ("_session_fp", "_chain_digest"):
            if hasattr(graph, attr):
                delattr(graph, attr)
        self.id = str(session_id)
        self.k = int(k)
        #: the balance tolerance this session's partitions were
        #: computed under (None = the ctx default); set by the serving
        #: register path so later repartitions without an explicit
        #: epsilon keep the SESSION's contract, not the wire default
        self.epsilon: Optional[float] = None
        self.base_fingerprint = graph_fingerprint(graph)
        # the base link of the chain is the FULL adjacency digest — paid
        # exactly once at register; every later identity is O(delta)
        self._chain = chain_digest(
            "base", caching.full_graph_digest(graph))
        self.graph = graph
        self.partition: Optional[np.ndarray] = None
        self.last_cut: Optional[int] = None
        self.last_gate_valid: Optional[bool] = None
        self.deltas_applied = 0
        self.in_place = 0
        self.rebuilds = 0
        self.repartitions = 0
        self.device_epoch = 0  # bumped on every bucket-crossing rebuild
        self.tracker = caching.BucketTracker()
        self._bucket = caching.bucket_key(graph.n, max(graph.m, 1), self.k)
        self.tracker.observe(graph.n, max(graph.m, 1), self.k)
        # drift accumulators since the last committed repartition
        self._pending_mass = 0
        self._pending_cut_mass = 0
        self._stamp()

    # -- identity ------------------------------------------------------

    @property
    def chain(self) -> str:
        return self._chain

    def digest(self) -> str:
        """The session's cache-identity digest.  ``dyn:``-prefixed so it
        can never collide with a plain ``full_graph_digest`` hex string
        of some other (differing) graph — the anti-aliasing guard."""
        return f"dyn:{self._chain}"

    def fingerprint(self) -> str:
        """The checkpoint-identity fingerprint: base fingerprint + the
        chain, so every chain step keys its own manifest."""
        return hashlib.sha256(
            f"dyn:{self.base_fingerprint}:{self._chain}".encode()
        ).hexdigest()[:24]

    def _stamp(self) -> None:
        """Stamp the evolving identity onto the graph object itself —
        the shortcut ``checkpoint.graph_fingerprint`` and
        ``caching.full_graph_digest`` read, which is what keeps a
        mutate O(delta) instead of O(m)."""
        self.graph._session_fp = self.fingerprint()
        self.graph._chain_digest = self.digest()

    # -- delta application ---------------------------------------------

    def apply(self, batch: DeltaBatch) -> dict:
        """Validate + apply one batch.  Returns the apply record:
        ``{"in_place": bool, "n": int, "m": int, "bucket": str,
        "delta_mass": int, "cut_touch_mass": int}``."""
        from ..resilience.policy import with_fallback

        patched = self._patch(batch)
        crossed = patched.bucket != self._bucket
        committed_in_place = False
        if not crossed:
            # the in-place ELIGIBILITY probe is the registered
            # degradation site: an injected `dynamic-apply` fault (or a
            # real in-place failure — a patched bucket disagreeing with
            # the device arrays would be checked here) degrades to the
            # rebuild path.  The probe is deliberately side-effect-free
            # and the commit runs exactly once OUTSIDE the site, so a
            # mid-probe failure can never leave a half-committed
            # session or double-fold the chain
            committed_in_place = bool(with_fallback(
                lambda: self._probe_in_place(patched),
                lambda exc: False,
                site="dynamic-apply", where=self.id,
            ))
        self._commit(batch, patched, in_place=committed_in_place)
        return {
            "in_place": bool(committed_in_place),
            "n": int(self.graph.n),
            "m": int(self.graph.m),
            "bucket": "/".join(str(x) for x in self._bucket),
            "delta_mass": int(patched.delta_mass),
            "cut_touch_mass": int(patched.cut_touch_mass),
        }

    def _probe_in_place(self, patched: _Patched) -> bool:
        """Eligibility check for the in-place commit (pure; raises
        DeltaApplyFailed on a genuine in-place failure — none exist
        today beyond injection, but the hook is where a bucket/device
        agreement check belongs)."""
        return True

    def _commit(self, batch: DeltaBatch, patched: _Patched,
                in_place: bool) -> bool:
        self.graph = patched.graph
        self.partition = patched.partition
        self.deltas_applied += 1
        if in_place:
            self.in_place += 1
        else:
            self.rebuilds += 1
            self.device_epoch += 1
        self._bucket = patched.bucket
        # executable-identity accounting: a same-bucket commit is a
        # tracker HIT (compiled programs reused), a crossing is a miss
        self.tracker.observe(
            patched.graph.n, max(patched.graph.m, 1), self.k)
        self._pending_mass += patched.delta_mass
        self._pending_cut_mass += patched.cut_touch_mass
        self._chain = chain_digest(self._chain, batch.digest())
        self._stamp()
        return True

    # -- repartition bookkeeping ---------------------------------------

    def drift_estimate(self, max_block_weights=None) -> Optional[float]:
        """Accumulated drift since the last committed repartition:
        cut-touching delta mass / total edge mass, plus the balance
        violation of the current (seeded) partition when caps are
        given.  None when the session has no partition yet (a cold run
        is the only option)."""
        if self.partition is None:
            return None
        # delta masses count each undirected edge once; the CSR stores
        # both directions, so the undirected total is half of it
        total = max(int(self.graph.total_edge_weight) // 2, 1)
        drift = self._pending_cut_mass / total
        if max_block_weights is not None:
            part = np.asarray(self.partition)
            labeled = part >= 0
            caps = np.asarray(max_block_weights, dtype=np.int64)
            bw = np.zeros(len(caps), dtype=np.int64)
            np.add.at(
                bw, part[labeled],
                self.graph.node_weight_array()[labeled])
            with np.errstate(divide="ignore"):
                viol = float((bw / np.maximum(caps, 1) - 1.0).max())
            drift += max(0.0, viol)
        return float(drift)

    def set_k(self, k: int) -> None:
        """Re-target the session's block count (the executable bucket
        keys on k, so a change re-anchors the in-place/rebuild
        accounting)."""
        if int(k) != self.k:
            self.k = int(k)
            self._bucket = caching.bucket_key(
                self.graph.n, max(self.graph.m, 1), self.k)
            self.tracker.observe(
                self.graph.n, max(self.graph.m, 1), self.k)

    def commit_partition(self, partition: np.ndarray, cut: int,
                         gate_valid: Optional[bool] = None) -> None:
        """Record a repartition result and fold it into the chain (two
        histories that repartitioned at different points must never
        share an identity — the partition state is part of it)."""
        partition = np.asarray(partition, dtype=np.int32)
        if partition.shape != (self.graph.n,):
            raise ValueError(
                f"partition shape {partition.shape} != ({self.graph.n},)")
        self.partition = partition
        self.last_cut = int(cut)
        self.last_gate_valid = gate_valid
        self.repartitions += 1
        self._pending_mass = 0
        self._pending_cut_mass = 0
        part_digest = hashlib.sha256(partition.tobytes()).hexdigest()[:16]
        self._chain = chain_digest(
            self._chain, f"repart:{self.k}:{part_digest}")
        self._stamp()

    def fold_repartition_marker(self, k: int, part_digest: str) -> None:
        """Replay one repartition link from a stored digest (the chain
        driver's resume path rebuilds the identity without re-running
        the repartitions)."""
        self._chain = chain_digest(self._chain, f"repart:{k}:{part_digest}")
        self._stamp()

    def reset_pending_drift(self) -> None:
        """Zero the drift accumulators to a committed-step boundary.
        The chain driver's resume path calls this after replaying
        deltas: the replayed applies accumulate delta mass (and with no
        partition restored yet, ALL of it counts as cut-touching), but
        the saved boundary is always post-commit where the accumulators
        were 0 — without the reset the first recomputed step's drift is
        inflated by the whole replayed chain and can flip its warm/cold
        decision vs the uninterrupted run."""
        self._pending_mass = 0
        self._pending_cut_mass = 0

    def summary(self) -> dict:
        """The session's row in the run report's ``dynamic`` section."""
        return {
            "id": self.id,
            "n": int(self.graph.n),
            "m": int(self.graph.m),
            "k": int(self.k),
            "deltas_applied": int(self.deltas_applied),
            "in_place": int(self.in_place),
            "rebuilds": int(self.rebuilds),
            "repartitions": int(self.repartitions),
            "chain": self.digest(),
            "bucket": "/".join(str(x) for x in self._bucket),
            "cut": self.last_cut if self.last_cut is None
            else int(self.last_cut),
        }

    # -- the CSR patch (pure; raises GraphFormatError) ------------------

    def _patch(self, batch: DeltaBatch) -> _Patched:
        g = self.graph
        n0, m0 = g.n, g.m
        n1 = n0 + batch.vertex_adds
        part = self.partition

        def _check_pairs(pairs: np.ndarray, what: str) -> None:
            if not len(pairs):
                return
            if pairs.min() < 0 or pairs.max() >= n1:
                raise GraphFormatError(
                    f"{what}: endpoint id out of range [0, {n1})")
            if (pairs[:, 0] == pairs[:, 1]).any():
                raise GraphFormatError(f"{what}: self loops not allowed")

        _check_pairs(batch.edge_inserts, "edge_inserts")
        _check_pairs(batch.edge_deletes, "edge_deletes")
        _check_pairs(batch.edge_weight_updates, "edge_weight_updates")
        for name, w in (("insert_weights", batch.insert_weights),
                        ("update_weights", batch.update_weights),
                        ("add_weights", batch.add_weights)):
            if w is not None and len(w) and w.min() < 1:
                raise GraphFormatError(f"{name}: weights must be >= 1")
        rm = np.unique(batch.vertex_removes)
        if len(rm) != len(batch.vertex_removes):
            raise GraphFormatError("vertex_removes: duplicate ids")
        if len(rm) and (rm.min() < 0 or rm.max() >= n1):
            raise GraphFormatError(
                f"vertex_removes: id out of range [0, {n1})")
        nwu = batch.node_weight_updates
        if len(nwu):
            if nwu[:, 0].min() < 0 or nwu[:, 0].max() >= n1:
                raise GraphFormatError(
                    f"node_weight_updates: id out of range [0, {n1})")
            if nwu[:, 1].min() < 1:
                raise GraphFormatError(
                    "node_weight_updates: weights must be >= 1")

        # current directed COO (both directions of every edge present)
        src = g.edge_sources().astype(np.int64)
        dst = g.adjncy.astype(np.int64)
        w = g.edge_weight_array().copy()
        keys = src * n1 + dst
        order = np.argsort(keys, kind="stable")
        skeys = keys[order]

        def _locate(pairs: np.ndarray, what: str) -> np.ndarray:
            """Directed-pair -> COO index; GraphFormatError on a miss."""
            pk = pairs[:, 0] * n1 + pairs[:, 1]
            pos = np.searchsorted(skeys, pk)
            pos_c = np.minimum(pos, max(len(skeys) - 1, 0))
            ok = len(skeys) > 0
            hit = (pos < len(skeys)) & (
                skeys[pos_c] == pk if ok else np.zeros(len(pk), bool))
            if not hit.all():
                bad = pairs[~hit][0]
                raise GraphFormatError(
                    f"{what}: edge ({int(bad[0] if bad[0] < bad[1] else bad[1])}, "
                    f"{int(max(bad))}) does not exist")
            return order[pos_c]

        def _both_dirs(pairs: np.ndarray) -> np.ndarray:
            return np.concatenate([pairs, pairs[:, ::-1]], axis=0)

        delta_mass = 0
        cut_touch = 0

        def _touch(pairs: np.ndarray, mass: np.ndarray) -> int:
            """Delta mass incident to the current cut: endpoints in
            different blocks, or touching an unlabeled/new vertex."""
            if part is None or not len(pairs):
                return int(mass.sum()) if len(pairs) else 0
            pu = np.where(pairs[:, 0] < n0, pairs[:, 0], -1)
            pv = np.where(pairs[:, 1] < n0, pairs[:, 1], -1)
            lu = np.where(pu >= 0, np.asarray(part)[pu], -1)
            lv = np.where(pv >= 0, np.asarray(part)[pv], -1)
            crossing = (lu != lv) | (lu < 0) | (lv < 0)
            return int(mass[crossing].sum())

        def _check_unique(pairs: np.ndarray, what: str) -> None:
            lo = np.minimum(pairs[:, 0], pairs[:, 1])
            hi = np.maximum(pairs[:, 0], pairs[:, 1])
            ck = lo * n1 + hi
            if len(np.unique(ck)) != len(ck):
                raise GraphFormatError(f"{what}: duplicate pair in batch")

        keep = np.ones(m0, dtype=bool)
        if len(batch.edge_deletes):
            _check_unique(batch.edge_deletes, "edge_deletes")
            idx = _locate(_both_dirs(batch.edge_deletes), "edge_deletes")
            keep[idx] = False
            half = idx[: len(batch.edge_deletes)]
            delta_mass += int(w[half].sum())
            cut_touch += _touch(batch.edge_deletes, w[half])
        if len(batch.edge_weight_updates):
            _check_unique(batch.edge_weight_updates, "edge_weight_updates")
            upd_dir = _both_dirs(batch.edge_weight_updates)
            idx = _locate(upd_dir, "edge_weight_updates")
            if not keep[idx].all():
                raise GraphFormatError(
                    "edge_weight_updates: edge also deleted in this batch")
            old_half = w[idx[: len(batch.edge_weight_updates)]].copy()
            w[idx] = np.concatenate(
                [batch.update_weights, batch.update_weights])
            dmass = np.abs(
                batch.update_weights.astype(np.int64) - old_half)
            delta_mass += int(dmass.sum())
            cut_touch += _touch(batch.edge_weight_updates, dmass)

        ins_src = ins_dst = ins_w = None
        if len(batch.edge_inserts):
            ins = batch.edge_inserts
            ins_w_half = (
                batch.insert_weights.astype(np.int64)
                if batch.insert_weights is not None
                else np.ones(len(ins), dtype=np.int64)
            )
            # canonical undirected key: duplicates within the batch
            # (including reversed restatements) are format errors
            lo = np.minimum(ins[:, 0], ins[:, 1])
            hi = np.maximum(ins[:, 0], ins[:, 1])
            ck = lo * n1 + hi
            if len(np.unique(ck)) != len(ck):
                raise GraphFormatError(
                    "edge_inserts: duplicate pair in batch")
            dk = _both_dirs(ins)
            pk = dk[:, 0] * n1 + dk[:, 1]
            pos = np.searchsorted(skeys, pk)
            pos_c = np.minimum(pos, max(len(skeys) - 1, 0))
            exists = (
                (pos < len(skeys)) & (skeys[pos_c] == pk)
                if len(skeys) else np.zeros(len(pk), bool)
            )
            # an edge deleted in this same batch may be re-inserted
            exists &= keep[order[pos_c]] if len(skeys) else False
            if exists.any():
                bad = dk[exists][0]
                raise GraphFormatError(
                    f"edge_inserts: edge ({int(min(bad))}, "
                    f"{int(max(bad))}) already exists")
            ins_src = dk[:, 0]
            ins_dst = dk[:, 1]
            ins_w = np.concatenate([ins_w_half, ins_w_half])
            delta_mass += int(ins_w_half.sum())
            cut_touch += _touch(ins, ins_w_half)

        # assemble the patched directed COO
        new_src = src[keep]
        new_dst = dst[keep]
        new_w = w[keep]
        if ins_src is not None:
            new_src = np.concatenate([new_src, ins_src])
            new_dst = np.concatenate([new_dst, ins_dst])
            new_w = np.concatenate([new_w, ins_w])

        # node weights: stay None (unit) when nothing weight-shaped
        # touches them, so unit graphs keep their compact form
        unit_adds = batch.add_weights is None or not len(batch.add_weights)
        need_nw = (
            g.node_weights is not None or len(nwu) or not unit_adds
        )
        nw = None
        if need_nw:
            nw = np.concatenate([
                g.node_weight_array(),
                (batch.add_weights if batch.add_weights is not None
                 else np.ones(batch.vertex_adds, dtype=np.int64)),
            ]) if batch.vertex_adds else g.node_weight_array().copy()
            if len(nwu):
                nw = np.asarray(nw).copy()
                nw[nwu[:, 0]] = nwu[:, 1]

        new_part = None
        if part is not None:
            new_part = np.concatenate([
                np.asarray(part, dtype=np.int32),
                np.full(batch.vertex_adds, -1, dtype=np.int32),
            ])

        if len(rm):
            # removed vertices take their incident edge mass with them
            node_keep = np.ones(n1, dtype=bool)
            node_keep[rm] = False
            e_rm = ~(node_keep[new_src] & node_keep[new_dst])
            if e_rm.any():
                gone_w = new_w[e_rm]
                gone_pairs = np.stack(
                    [new_src[e_rm], new_dst[e_rm]], axis=1)
                half = gone_pairs[:, 0] < gone_pairs[:, 1]
                delta_mass += int(gone_w[half].sum())
                cut_touch += _touch(gone_pairs[half], gone_w[half])
            remap = np.cumsum(node_keep) - 1
            new_src = remap[new_src[~e_rm]]
            new_dst = remap[new_dst[~e_rm]]
            new_w = new_w[~e_rm]
            if nw is not None:
                nw = np.asarray(nw)[node_keep]
            if new_part is not None:
                new_part = new_part[node_keep]
            n_new = int(node_keep.sum())
        else:
            n_new = n1

        patched_graph = from_edge_list(
            n_new,
            np.stack([new_src, new_dst], axis=1),
            edge_weights=new_w,
            node_weights=nw,
            symmetrize=False,
        )
        unseeded = (
            int((new_part < 0).sum()) if new_part is not None else 0
        )
        return _Patched(
            graph=patched_graph,
            partition=new_part,
            bucket=caching.bucket_key(
                n_new, max(patched_graph.m, 1), self.k),
            delta_mass=delta_mass,
            cut_touch_mass=cut_touch,
            new_unseeded=unseeded,
        )
