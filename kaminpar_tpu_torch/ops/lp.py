"""Bulk-synchronous size-constrained label propagation (counterpart of
kaminpar_tpu/ops/lp.py).

Each round rates (node, neighbour-cluster) connections with the level's
rating engine, picks a per-node arg-max with hashed ties, commits moves
under the weight cap with a capacity-respecting prefix pass, and refreshes
the active set — the JAX package's round, operation for operation.  Its
`lax.while_loop` over rounds and its `lax.cond` branches become host
control flow here: one scalar readback per round decides whether to go
on, and a branch predicate is read back where the JAX package computed it
on the device.  The TPU launch chunking is not ported: every round is its
own set of launches already.

Post-passes mirroring the reference: `cluster_isolated_nodes`
(label_propagation.h:872-917) and `two_hop_cluster` (:919-1191).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Tuple

import numpy as np
import torch

from ..dtypes import ACC_DTYPE, INT32_MAX, INT32_MIN
from ..graphs.csr import DeviceGraph
from .gather import gather_i32
from .rating import (
    SCATTER_FALLBACK_FRAC,
    scatter_best_from_slots,
    select_engine,
)
from .segments import (
    accept_prefix_by_capacity,
    aggregate_by_key,
    apply_move_weight_delta,
    argmax_per_segment,
    best_from_dense,
    best_from_rating_table,
    connection_to_label,
    connection_to_own_label,
    connection_to_own_rows,
    dense_block_ratings,
    expand_active_rows,
    hash_u32,
    hashed_rating_table,
    neighbor_any_true,
    packed_afterburner_gain,
    packed_afterburner_gain_rows,
    rating_top3_by_sort,
    rating_topk_rows,
    segment_max,
    segment_min,
    segment_sum,
)


@dataclass(frozen=True)
class LPConfig:
    """Knobs mirroring LabelPropagationConfig plus the bulk-sync ones."""

    num_iterations: int = 5
    participation: float = 0.5
    allow_tie_moves: bool = True
    use_active_set: bool = True
    two_hop: bool = True
    cluster_isolated: bool = True
    refinement: bool = False
    # dist path only: join only clusters led by a node of the same shard
    # (the reference's LocalLPClusterer)
    dist_local_only: bool = False
    rating: str = "auto"
    num_slots: int = 32
    topk: int = 6
    scatter_fallback: float = SCATTER_FALLBACK_FRAC


def _select_engine(cfg: LPConfig, num_clusters: int, m_pad: int,
                   n_pad: int) -> str:
    engine, _ = select_engine(
        cfg.rating, num_clusters, n_pad, m_pad, num_slots=cfg.num_slots
    )
    return engine


# Below this many edge slots a full round is cheap enough that delta
# rounds are not used (the JAX package's threshold; tests lower it in both
# packages to exercise the delta path at small n).
DELTA_MIN_EDGE_SLOTS = 1 << 22


def _delta_slots(graph: DeviceGraph, cfg: LPConfig, engine: str) -> int | None:
    """Delta-round buffer size (m_pad / 4), or None when delta rounds are
    off for this level and engine."""
    if not cfg.use_active_set:
        return None
    if engine not in ("sort2", "dense", "scatter"):
        return None
    m_slots = graph.src.shape[0]
    floor = (
        min(DELTA_MIN_EDGE_SLOTS, 1 << 20)
        if engine == "scatter" else DELTA_MIN_EDGE_SLOTS
    )
    if m_slots < floor:
        return None
    return m_slots // 4


def _as_weight(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=ACC_DTYPE, device=device)


def _scatter_predicate(n_bad: torch.Tensor, n_all: torch.Tensor,
                       frac: float) -> bool:
    """float32 `n_bad <= frac * n_all`, as the JAX fallback predicate."""
    bad, total = (int(v) for v in torch.stack([n_bad, n_all]).tolist())
    return bool(np.float32(bad) <= np.float32(frac) * np.float32(total))


def lp_round(
    graph: DeviceGraph,
    labels: torch.Tensor,
    cluster_weights: torch.Tensor,
    max_cluster_weight: torch.Tensor,
    active: torch.Tensor,
    salt: int,
    cfg: LPConfig,
    communities: torch.Tensor | None = None,
    rows=None,
):
    """One bulk-synchronous LP round; returns (new_labels,
    new_cluster_weights, new_active, num_wanting).  `rows` (an
    expand_active_rows result) makes it a delta round over the active
    rows only (sort2 / dense / scatter engines)."""
    n_pad = graph.n_pad
    m_slots = graph.src.shape[0]
    dev = graph.device
    C = cluster_weights.shape[0]
    cap = max_cluster_weight.expand(C)
    node_w = graph.node_w
    engine = _select_engine(cfg, C, graph.m_pad, n_pad)
    if rows is not None and engine not in ("sort2", "dense", "scatter"):
        raise ValueError(f"delta rounds are not supported by engine {engine}")
    barred = torch.zeros(n_pad, dtype=torch.bool, device=dev)
    node_ids = graph.node_ids()

    valid = None
    if engine in ("sort2", "dense", "scatter"):
        if rows is not None:
            owner_c, owner_key, edge_id, valid, start, end = rows
            eid = edge_id.clamp(0, m_slots - 1)
            dst_b = torch.where(valid, gather_i32(graph.dst, eid), n_pad - 1)
            w_b = torch.where(valid, gather_i32(graph.edge_w, eid), 0)
            deg_eff = end - start
        else:
            owner_c = owner_key = graph.src
            dst_b = graph.dst
            w_b = graph.edge_w
            start = graph.row_ptr[:-1]
            end = graph.row_ptr[1:]
            deg_eff = graph.degrees

    def neighbor_labels():
        nb = gather_i32(labels, dst_b)
        return torch.where(valid, nb, -1) if valid is not None else nb

    if engine == "sort2":
        avg_degree = graph.m_pad / max(C, 1)
        K = cfg.topk if avg_degree <= 32 else max(cfg.topk, 16)
        nb = neighbor_labels()
        own_slot = labels[owner_c]
        topk = rating_topk_rows(owner_key, nb, w_b, end, deg_eff, salt, K)
        labs, vals = topk[0::2], topk[1::2]
        w_cur = connection_to_own_rows(nb, w_b, own_slot, start, end)

        def fits(lab):
            lab_c = lab.clamp(0, C - 1)
            ok = (lab >= 0) & (
                cluster_weights[lab_c].to(ACC_DTYPE) + node_w.to(ACC_DTYPE)
                <= cap[lab_c]
            )
            if communities is not None:
                lab_n = lab.clamp(0, n_pad - 1)
                ok = ok & (communities[lab_n] == communities)
            return ok

        best = torch.full((n_pad,), -1, dtype=torch.int32, device=dev)
        best_w = torch.full((n_pad,), INT32_MIN, dtype=ACC_DTYPE, device=dev)
        for lab_j, val_j in zip(reversed(labs), reversed(vals)):
            ok = (lab_j != labels) & fits(lab_j)
            best = torch.where(ok, lab_j, best)
            best_w = torch.where(ok, val_j, best_w)
    elif engine == "scatter":
        # the fused K3 rates each row's span (spans past a delta round's
        # buffer are cut at it); the neighbour labels are gathered only
        # when the sort fallback needs them
        best, best_w, w_cur, fully_rated = scatter_best_from_slots(
            start, end, dst_b, w_b, labels, cluster_weights, node_w, cap,
            cfg.num_slots, salt, communities=communities,
        )
        act_real = active & (node_ids < graph.n)
        use_scatter = _scatter_predicate(
            (act_real & ~fully_rated).sum(dtype=torch.int32),
            act_real.sum(dtype=torch.int32),
            cfg.scatter_fallback,
        )
        if use_scatter:
            barred = ~fully_rated
        else:
            nb = neighbor_labels()
            seg_owner = (
                torch.where(valid, owner_c, -1) if valid is not None
                else owner_c
            )
            seg_g, key_g, w_g = aggregate_by_key(seg_owner, nb, w_b)
            key_c = key_g.clamp(0, C - 1)
            seg_c = seg_g.clamp(0, n_pad - 1)
            fits_g = (
                cluster_weights[key_c].to(ACC_DTYPE)
                + node_w[seg_c].to(ACC_DTYPE)
                <= cap[key_c]
            )
            feasible = (seg_g >= 0) & (key_g != labels[seg_c]) & fits_g
            if communities is not None:
                key_n = key_g.clamp(0, n_pad - 1)
                feasible = feasible & (
                    communities[key_n] == communities[seg_c]
                )
            best, best_w = argmax_per_segment(
                seg_g, key_g, w_g, n_pad, tie_salt=salt, feasible=feasible
            )
            w_cur = connection_to_label(seg_g, key_g, w_g, labels, n_pad)
        best = torch.where(barred, -1, best)
        best_w = torch.where(barred, INT32_MIN, best_w)
    elif engine == "dense":
        conn = dense_block_ratings(start, end, dst_b, w_b, labels, n_pad, C)
        best, best_w, w_cur = best_from_dense(
            conn, labels, cluster_weights, node_w, cap, salt,
            communities=communities,
        )
    elif engine == "hash":
        neighbor_cluster = gather_i32(labels, graph.dst)
        slot_label, slot_w = hashed_rating_table(
            graph.src, neighbor_cluster, graph.edge_w, n_pad,
            cfg.num_slots, salt,
        )
        best, best_w = best_from_rating_table(
            slot_label, slot_w, labels, cluster_weights, node_w,
            cap, salt ^ 0x51AB, communities=communities,
        )
        w_cur = connection_to_own_label(
            graph.src, neighbor_cluster, graph.edge_w, labels, n_pad
        )
    elif engine == "sort":
        neighbor_cluster = gather_i32(labels, graph.dst)
        seg_g, key_g, w_g = aggregate_by_key(
            graph.src, neighbor_cluster, graph.edge_w
        )
        key_c = key_g.clamp(0, C - 1)
        seg_c = seg_g.clamp(0, n_pad - 1)
        fits_g = (
            cluster_weights[key_c].to(ACC_DTYPE)
            + node_w[seg_c].to(ACC_DTYPE)
            <= cap[key_c]
        )
        feasible = (seg_g >= 0) & (key_g != labels[seg_c]) & fits_g
        if communities is not None:
            feasible = feasible & (communities[key_c] == communities[seg_c])
        best, best_w = argmax_per_segment(
            seg_g, key_g, w_g, n_pad, tie_salt=salt, feasible=feasible
        )
        w_cur = connection_to_label(seg_g, key_g, w_g, labels, n_pad)
    else:
        raise ValueError(f"unknown rating engine {engine!r}")

    # -- select
    gain = best_w - w_cur
    tie_moves = cfg.allow_tie_moves and not cfg.refinement
    if cfg.refinement:
        improves = gain > 0
    elif tie_moves:
        tie_dir_ok = hash_u32(best, salt ^ 0x5BD1) < hash_u32(
            labels, salt ^ 0x5BD1
        )
        improves = (gain > 0) | ((gain == 0) & (best_w > 0) & tie_dir_ok)
    else:
        improves = gain > 0
    participate = hash_u32(node_ids, salt ^ 0x27D4) < int(
        cfg.participation * 2147483647.0
    )
    wants = (
        (best >= 0) & (best != labels) & improves & active
        & (node_ids < graph.n)
    )
    target = torch.where(wants & participate, best, -1)

    if cfg.refinement:
        # afterburner: keep only candidates whose gain stays positive when
        # every neighbour ordered before them has already moved
        candidate = target >= 0
        next_lab = torch.where(candidate, target, labels)
        if rows is not None:
            adj_gain, _, _ = packed_afterburner_gain_rows(
                owner_c, dst_b, w_b, start, end,
                labels, next_lab, gain, candidate, C,
            )
        else:
            adj_gain = packed_afterburner_gain(
                graph.src, graph.dst, graph.edge_w, graph.row_ptr,
                labels, next_lab, gain, candidate, C,
            )
        target = torch.where(candidate & (adj_gain > 0), target, -1)

    # -- commit: never exceed the cap even under simultaneous joins
    headroom = (cap - cluster_weights.to(ACC_DTYPE)).clamp(min=0)
    prio = hash_u32(node_ids, salt ^ 0x165667B1)
    accept = accept_prefix_by_capacity(target, prio, node_w, headroom)

    # -- apply
    new_labels = torch.where(accept, target, labels)
    new_cluster_weights = apply_move_weight_delta(
        cluster_weights, labels, target, accept, node_w
    )

    # -- active set refresh (label_propagation.h:507-513)
    if cfg.use_active_set:
        if rows is not None:
            moved_slot = accept[owner_c] & valid
            neigh_moved = segment_max(
                moved_slot.to(torch.int32), dst_b, n_pad
            ) > 0
        else:
            neigh_moved = neighbor_any_true(accept, graph.dst, graph.row_ptr)
        usable = gain > 0
        if tie_moves:
            usable = usable | ((gain == 0) & (best_w > 0))
        may_move_later = active & (best >= 0) & (best != labels) & usable
        new_active = (
            accept | neigh_moved | (may_move_later & ~accept)
            | (barred & active)
        )
    else:
        new_active = torch.ones_like(active)
    num_wanting = wants.sum(dtype=torch.int32)
    return new_labels, new_cluster_weights, new_active, num_wanting


def _round_with_delta(
    graph: DeviceGraph,
    labels: torch.Tensor,
    weights: torch.Tensor,
    max_cluster_weight: torch.Tensor,
    active: torch.Tensor,
    salt: int,
    cfg: LPConfig,
    communities: torch.Tensor | None,
    i: int,
):
    """One LP round, delta-dispatched: after the first round, when the
    active rows fit the m_pad / 4 buffer, the round runs on the compacted
    buffer instead of the full edge list."""
    engine = _select_engine(cfg, weights.shape[0], graph.m_pad, graph.n_pad)
    dslots = _delta_slots(graph, cfg, engine)
    if dslots is not None and i > 0:
        deg = graph.degrees
        total = int(
            torch.where(active & (deg > 0), deg, 0).sum(dtype=torch.int32)
        )
        if total <= dslots:
            rows = expand_active_rows(graph.row_ptr, deg, active, dslots)
            return lp_round(
                graph, labels, weights, max_cluster_weight, active, salt,
                cfg, communities=communities, rows=rows,
            )
    return lp_round(
        graph, labels, weights, max_cluster_weight, active, salt, cfg,
        communities=communities,
    )


def lp_cluster(
    graph: DeviceGraph,
    max_cluster_weight,
    seed: int,
    cfg: LPConfig = LPConfig(),
    num_iterations: int | None = None,
    communities: torch.Tensor | None = None,
) -> torch.Tensor:
    """Size-constrained LP clustering: singletons, then up to
    `num_iterations` rounds (stopping when no node wants to move), then
    isolated-node and two-hop post-passes.  Returns i32[n_pad] labels
    whose values are node ids."""
    dev = graph.device
    mcw = _as_weight(max_cluster_weight, dev)
    iters = num_iterations if num_iterations is not None else cfg.num_iterations
    labels = graph.node_ids()
    weights = graph.node_w.to(ACC_DTYPE).clone()
    active = torch.ones(graph.n_pad, dtype=torch.bool, device=dev)
    for i in range(iters):
        salt = (int(seed) * 131071 + i * 1566083941) & 0x7FFFFFFF
        labels, weights, active, moved = _round_with_delta(
            graph, labels, weights, mcw, active, salt, cfg, communities, i
        )
        if int(moved) == 0:
            break
    if communities is None:
        if cfg.cluster_isolated:
            labels, weights = cluster_isolated_nodes(
                graph, labels, weights, mcw
            )
        if cfg.two_hop:
            labels, weights = two_hop_cluster(
                graph, labels, weights, mcw, seed, cfg
            )
    return labels


def lp_refine(
    graph: DeviceGraph,
    partition: torch.Tensor,
    k: int,
    max_block_weights: torch.Tensor,
    seed: int,
    cfg: LPConfig = LPConfig(refinement=True),
    num_iterations: int | None = None,
) -> torch.Tensor:
    """LP refinement: the LP round with clusters fixed to the k blocks and
    only strictly positive-gain moves under the per-block max weights."""
    iters = num_iterations if num_iterations is not None else cfg.num_iterations
    if not cfg.refinement:
        cfg = replace(cfg, allow_tie_moves=False, refinement=True)
    part = partition.clamp(0, k - 1).to(torch.int32)
    bw = segment_sum(graph.node_w.to(ACC_DTYPE), part, k)
    active = torch.ones(graph.n_pad, dtype=torch.bool, device=graph.device)
    max_block_weights = max_block_weights.to(ACC_DTYPE)
    for i in range(iters):
        salt = (int(seed) * 92821 + i * 1566083941) & 0x7FFFFFFF
        part, bw, active, moved = _round_with_delta(
            graph, part, bw, max_block_weights, active, salt, cfg, None, i
        )
        if int(moved) == 0:
            break
    return part


def cluster_isolated_nodes(
    graph: DeviceGraph,
    labels: torch.Tensor,
    cluster_weights: torch.Tensor,
    max_cluster_weight: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge isolated singleton nodes into shared clusters under the weight
    cap: node i's bin is floor(prefix weight / cap), the first member of a
    bin leads it, and a capacity-respecting prefix pass admits joiners."""
    n_pad = graph.n_pad
    node_ids = graph.node_ids()
    is_real = node_ids < graph.n
    iso = (graph.degrees == 0) & is_real & (labels == node_ids)
    cap = max_cluster_weight.to(ACC_DTYPE).clamp(min=1)
    w = torch.where(iso, graph.node_w, 0).to(ACC_DTYPE)
    cum_before = torch.cumsum(w, 0, dtype=ACC_DTYPE) - w
    bin_id = torch.where(iso, torch.div(cum_before, cap,
                                        rounding_mode="floor"), -1)
    bin_c = bin_id.clamp(0, n_pad - 1)
    first_in_bin = segment_min(
        torch.where(iso, node_ids, INT32_MAX), bin_c, n_pad
    )
    leader = torch.where(iso, first_in_bin[bin_c], -1)
    joiner = iso & (leader != node_ids) & (leader >= 0)
    target = torch.where(joiner, leader, -1)
    headroom = (
        max_cluster_weight.expand(n_pad) - cluster_weights.to(ACC_DTYPE)
    ).clamp(min=0)
    accept = accept_prefix_by_capacity(
        target, node_ids, graph.node_w, headroom
    )
    new_labels = torch.where(accept, target, labels)
    return new_labels, apply_move_weight_delta(
        cluster_weights, labels, target, accept, graph.node_w
    )


def two_hop_cluster(
    graph: DeviceGraph,
    labels: torch.Tensor,
    cluster_weights: torch.Tensor,
    max_cluster_weight: torch.Tensor,
    seed: int,
    cfg: LPConfig = LPConfig(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-hop clustering of leftover singletons: singletons sharing a
    favoured cluster (best-rated, ignoring the cap) merge; the smallest
    id per favoured cluster leads, the rest join under the cap."""
    n_pad = graph.n_pad
    C = cluster_weights.shape[0]
    node_ids = graph.node_ids()
    is_real = node_ids < graph.n
    singleton = (
        (labels == node_ids)
        & (cluster_weights[labels.clamp(0, n_pad - 1)] == graph.node_w)
        & is_real
        & (graph.degrees > 0)
    )
    engine = _select_engine(cfg, C, graph.m_pad, n_pad)

    def neighbor_cluster():
        return gather_i32(labels, graph.dst)

    def sort_favored():
        seg_g, key_g, w_g = aggregate_by_key(
            graph.src, neighbor_cluster(), graph.edge_w
        )
        fav, _ = argmax_per_segment(seg_g, key_g, w_g, n_pad, tie_salt=seed)
        return fav

    if engine == "scatter":
        # the JAX package rates the COO edges (graph.src) here; the CSR
        # spans hold the same edges but the pad edges, which only touch
        # the pad row and leave every output unchanged
        fav, fav_w, _, fully_rated = scatter_best_from_slots(
            graph.row_ptr[:-1], graph.row_ptr[1:], graph.dst, graph.edge_w,
            labels, cluster_weights, graph.node_w,
            max_cluster_weight.expand(C), cfg.num_slots, seed,
            require_fit=False,
        )
        use_scatter = _scatter_predicate(
            (singleton & ~fully_rated).sum(dtype=torch.int32),
            singleton.sum(dtype=torch.int32),
            cfg.scatter_fallback,
        )
        if use_scatter:
            favored = torch.where(fully_rated & (fav_w > 0), fav, -1)
        else:
            favored = sort_favored()
    elif engine == "sort2":
        top = rating_top3_by_sort(graph, neighbor_cluster(), seed, k_best=1)
        favored = torch.where(top[1] > 0, top[0], -1)
    elif engine == "hash":
        slot_label, slot_w = hashed_rating_table(
            graph.src, neighbor_cluster(), graph.edge_w, n_pad,
            cfg.num_slots, seed,
        )
        favored, fav_w = best_from_rating_table(
            slot_label, slot_w, labels, cluster_weights, graph.node_w,
            max_cluster_weight.expand(C), seed, require_fit=False,
        )
        favored = torch.where(fav_w > 0, favored, -1)
    else:
        favored = sort_favored()

    fav = torch.where(singleton & (favored >= 0), favored, -1)
    fav_c = fav.clamp(0, n_pad - 1)
    leader = segment_min(
        torch.where(fav >= 0, node_ids, INT32_MAX), fav_c, n_pad
    )
    my_leader = torch.where(fav >= 0, leader[fav_c], -1)
    joiner = (fav >= 0) & (my_leader != node_ids) & (my_leader >= 0)
    target = torch.where(joiner, my_leader, -1)
    headroom = (
        max_cluster_weight.expand(n_pad) - cluster_weights.to(ACC_DTYPE)
    ).clamp(min=0)
    accept = accept_prefix_by_capacity(
        target, node_ids, graph.node_w, headroom
    )
    new_labels = torch.where(accept, target, labels)
    return new_labels, apply_move_weight_delta(
        cluster_weights, labels, target, accept, graph.node_w
    )
