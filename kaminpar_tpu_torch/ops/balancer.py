"""Overload / underload balancers (counterpart of kaminpar_tpu/ops/balancer.py).

Bulk-synchronous rounds: every node of an overloaded block picks its best
feasible target block from a dense (n, k) connection table, movers are
ranked per source block by relative gain, and sorted prefix passes accept
movers that cover the overload and fit the targets' headroom.  The JAX
`lax.while_loop` over rounds is a host loop here (one readback per round).
`host_balance` is the exact greedy host backstop, copied.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..dtypes import ACC_DTYPE
from ..graphs.csr import DeviceGraph
from .gather import gather_i32
from .segments import (
    accept_prefix_by_capacity,
    aggregate_by_key,
    argmax_per_segment,
    best_from_dense,
    connection_to_label,
    dense_block_ratings,
    segment_sum,
)

# above this k the dense (n, k) table gives way to edge aggregation
BALANCER_DENSE_MAX_K = 256


def relative_gain_key(gain: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """float32 surrogate for compute_relative_gain: gain > 0 -> gain *
    weight, else gain / weight (a descending priority)."""
    w = weight.to(torch.float32).clamp(min=1.0)
    g = gain.to(torch.float32)
    return torch.where(g > 0, g * w, g / w)


def _block_weights(graph: DeviceGraph, partition: torch.Tensor,
                   k: int) -> torch.Tensor:
    return segment_sum(
        graph.node_w.to(ACC_DTYPE), partition.clamp(0, k - 1), k
    )


def overload_balance_round(
    graph: DeviceGraph,
    partition: torch.Tensor,
    k: int,
    max_block_weights: torch.Tensor,
    salt: int,
    conn: torch.Tensor | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One balancing round; returns (partition, moved).  `conn` is an
    optional pre-built dense connection table for `partition` (Jet keeps
    one), which makes the round free of edge-wide work."""
    n_pad = graph.n_pad
    node_w = graph.node_w
    is_real = graph.node_ids() < graph.n
    part = partition.clamp(0, k - 1).to(torch.int32)
    bw = _block_weights(graph, part, k)
    cap = max_block_weights.to(ACC_DTYPE)
    overload = (bw - cap).clamp(min=0)
    headroom = (cap - bw).clamp(min=0)
    in_overloaded = (overload[part] > 0) & is_real

    if k <= BALANCER_DENSE_MAX_K:
        if conn is None:
            conn = dense_block_ratings(
                graph.row_ptr[:-1], graph.row_ptr[1:], graph.dst,
                graph.edge_w, part, n_pad, k,
            )
        best, best_w, w_own = best_from_dense(conn, part, bw, node_w, cap,
                                              salt)
    else:
        neigh_block = gather_i32(part, graph.dst)
        seg_g, key_g, w_g = aggregate_by_key(graph.src, neigh_block,
                                             graph.edge_w)
        key_c = key_g.clamp(0, k - 1)
        seg_c = seg_g.clamp(0, n_pad - 1)
        fits = bw[key_c] + node_w[seg_c].to(ACC_DTYPE) <= cap[key_c]
        feasible = (seg_g >= 0) & (key_g != part[seg_c]) & fits
        best, best_w = argmax_per_segment(
            seg_g, key_g, w_g, n_pad, tie_salt=salt, feasible=feasible
        )
        w_own = connection_to_label(seg_g, key_g, w_g, part, n_pad)
        headroom_now = (cap - bw).clamp(min=0)
        fallback = torch.argmax(headroom_now).to(torch.int32)
        fb_ok = (node_w.to(ACC_DTYPE) <= headroom_now[fallback]) & (
            part != fallback
        )
        use_fb = (best < 0) & fb_ok
        best = torch.where(use_fb, fallback, best)
        best_w = torch.where(use_fb, 0, best_w)

    target = best
    gain = best_w - w_own
    mover = in_overloaded & (target >= 0)
    target = torch.where(mover, target, -1)
    order_key = -relative_gain_key(gain, node_w)
    src_block = torch.where(mover, part, -1)
    accept_out = accept_prefix_by_capacity(
        src_block, order_key, node_w, overload, reach=True
    )
    target2 = torch.where(accept_out, target, -1)
    accept_in = accept_prefix_by_capacity(target2, order_key, node_w,
                                          headroom)
    accept = accept_out & accept_in
    new_part = torch.where(accept, target, part)
    return new_part, accept.sum(dtype=torch.int32)


def overload_balance(
    graph: DeviceGraph,
    partition: torch.Tensor,
    k: int,
    max_block_weights: torch.Tensor,
    seed: int,
    max_rounds: int = 8,
) -> torch.Tensor:
    """Balancing rounds until feasible, stalled or `max_rounds`."""
    cap = max_block_weights.to(ACC_DTYPE)
    part = partition.clamp(0, k - 1)
    moved = 1
    for i in range(max_rounds):
        violation = (_block_weights(graph, part, k) - cap).clamp(min=0).sum(
            dtype=ACC_DTYPE
        )
        if moved == 0 or int(violation) <= 0:
            break
        salt = (int(seed) * 48271 + i * 1566083941) & 0x7FFFFFFF
        part, moved_t = overload_balance_round(
            graph, part, k, max_block_weights, salt
        )
        moved = int(moved_t)
    return part


def underload_balance_round(
    graph: DeviceGraph,
    part: torch.Tensor,
    k: int,
    min_block_weights: torch.Tensor,
    salt: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One underload round: pull weight into blocks below their min
    weight, taking the cheapest movers from blocks with surplus."""
    n_pad = graph.n_pad
    node_w = graph.node_w
    is_real = graph.node_ids() < graph.n
    bw = _block_weights(graph, part, k)
    mins = min_block_weights.to(ACC_DTYPE)
    deficit = (mins - bw).clamp(min=0)
    surplus = (bw - mins).clamp(min=0)
    if k <= BALANCER_DENSE_MAX_K:
        conn = dense_block_ratings(
            graph.row_ptr[:-1], graph.row_ptr[1:], graph.dst, graph.edge_w,
            part, n_pad, k,
        )
        best, best_w, _ = best_from_dense(
            conn, part, bw, node_w, bw, salt,
            require_fit=False, allowed=deficit > 0,
        )
    else:
        neigh_block = gather_i32(part, graph.dst)
        seg_g, key_g, w_g = aggregate_by_key(graph.src, neigh_block,
                                             graph.edge_w)
        key_c = key_g.clamp(0, k - 1)
        seg_c = seg_g.clamp(0, n_pad - 1)
        feasible = (
            (seg_g >= 0) & (key_g != part[seg_c]) & (deficit[key_c] > 0)
        )
        best, best_w = argmax_per_segment(
            seg_g, key_g, w_g, n_pad, tie_salt=salt, feasible=feasible
        )
    fallback = torch.argmax(deficit).to(torch.int32)
    use_fallback = (best < 0) & (deficit[fallback] > 0) & (part != fallback)
    best = torch.where(use_fallback, fallback, best)
    best_w = torch.where(use_fallback, 0, best_w)
    mover = is_real & (best >= 0) & (surplus[part] >= node_w.to(ACC_DTYPE))
    target = torch.where(mover, best, -1)
    order_key = -relative_gain_key(best_w, node_w)
    accept_out = accept_prefix_by_capacity(
        torch.where(mover, part, -1), order_key, node_w, surplus
    )
    target2 = torch.where(accept_out, target, -1)
    accept_in = accept_prefix_by_capacity(
        target2, order_key, node_w, deficit, reach=True
    )
    accept = accept_out & accept_in
    return torch.where(accept, target, part), accept.sum(dtype=torch.int32)


def underload_balance(
    graph: DeviceGraph,
    partition: torch.Tensor,
    k: int,
    max_block_weights: torch.Tensor,
    min_block_weights: torch.Tensor,
    seed: int,
    max_rounds: int = 8,
) -> torch.Tensor:
    """Underload rounds until no deficit remains, stalled or
    `max_rounds`."""
    mins = min_block_weights.to(ACC_DTYPE)
    part = partition.clamp(0, k - 1)
    moved = 1
    for i in range(max_rounds):
        deficit = (mins - _block_weights(graph, part, k)).clamp(min=0).sum(
            dtype=ACC_DTYPE
        )
        if moved == 0 or int(deficit) <= 0:
            break
        salt = (int(seed) * 16807 + i * 1566083941) & 0x7FFFFFFF
        part, moved_t = underload_balance_round(
            graph, part, k, min_block_weights, salt
        )
        moved = int(moved_t)
    return part


def host_balance(
    node_w: np.ndarray,
    adjacency: Tuple[np.ndarray, np.ndarray, np.ndarray],
    partition: np.ndarray,
    max_block_weights: np.ndarray,
) -> np.ndarray:
    """Exact greedy host balancer — the strict-balance backstop.  Moves the
    relatively-cheapest nodes out of overloaded blocks one at a time until
    feasible (own copy of the JAX package's numpy version)."""
    xadj, adjncy, edge_w = adjacency
    part = partition.copy()
    n = len(part)
    k = len(max_block_weights)
    bw = np.zeros(k, dtype=np.int64)
    np.add.at(bw, part, node_w)

    src = np.repeat(np.arange(n), np.diff(xadj))
    internal = np.zeros(n, dtype=np.int64)
    same = part[src] == part[adjncy]
    np.add.at(internal, src[same], edge_w[same])

    order = np.lexsort((node_w, internal))
    for _ in range(n * 2):
        over_blocks = np.flatnonzero(bw > max_block_weights)
        if len(over_blocks) == 0:
            break
        b = int(
            over_blocks[np.argmax(bw[over_blocks] - max_block_weights[over_blocks])]
        )
        movers = order[part[order] == b]
        moved = False
        for u in movers:
            room = max_block_weights - bw
            room[b] = -1
            lo, hi = int(xadj[u]), int(xadj[u + 1])
            conn = np.zeros(k, dtype=np.int64)
            np.add.at(conn, part[adjncy[lo:hi]], edge_w[lo:hi])
            conn[room < node_w[u]] = -1
            conn[b] = -1
            t = int(np.argmax(conn))
            if conn[t] < 0:
                t = int(np.argmax(room))
                if room[t] < node_w[u]:
                    continue
            part[u] = t
            bw[b] -= node_w[u]
            bw[t] += node_w[u]
            moved = True
            break
        if not moved:
            break
    return part
