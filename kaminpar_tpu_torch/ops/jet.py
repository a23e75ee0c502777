"""Jet refinement (counterpart of kaminpar_tpu/ops/jet.py; the reference's
jet_refiner.cc, after Gilbert et al., "Jet: Multilevel Graph Partitioning
on GPUs").  Per iteration: every unlocked border node picks its best
external block and becomes a candidate if its gain beats the temperature
threshold; the afterburner keeps candidates whose gain stays positive when
better-ordered neighbours move first; accepted moves execute in bulk; the
overload balancer restores feasibility; the best feasible partition seen
is kept, with a rollback at the end of each round.

The dense (n, k) connection table (K2) is maintained incrementally across
iterations exactly as in the JAX package.  The JAX package runs chunks of
iterations in one device program; here the iterations are a host loop
that reads back the entering cut and feasibility once per iteration, and
iteration numbering, chunk bookkeeping and every float32 comparison are
kept as the JAX driver has them, so both packages visit the same states.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..context import JetRefinementContext
from ..dtypes import ACC_DTYPE, INT32_MAX
from ..graphs.csr import DeviceGraph
from .balancer import overload_balance_round
from .gather import gather_i32
from .rating import best_from_dense, dense_block_ratings
from .segments import (
    MAX_FUSED_EDGE_SLOTS,
    expand_active_rows,
    packed_afterburner_gain,
    packed_afterburner_gain_rows,
    prune_candidates_to_budget,
    segment_sum,
)

# below this many edge slots the incremental machinery is off (the JAX
# package's threshold; tests lower it in both packages)
DELTA_MIN_EDGE_SLOTS = 1 << 22
# largest dense (n_pad, k) conn table Jet materializes
JET_DENSE_MAX_ENTRIES = 1 << 28


def _delta_slots(graph: DeviceGraph) -> int | None:
    m_slots = graph.src.shape[0]
    if m_slots < DELTA_MIN_EDGE_SLOTS:
        return None
    return m_slots // 4


def _full_ratings(graph: DeviceGraph, part: torch.Tensor, k: int):
    return dense_block_ratings(
        graph.row_ptr[:-1], graph.row_ptr[1:], graph.dst, graph.edge_w,
        part, graph.n_pad, k,
    )


def _conn_own(conn: torch.Tensor, part: torch.Tensor, k: int):
    return conn.gather(1, part.clamp(0, k - 1)[:, None].to(torch.int64))[:, 0]


def _conn_cut(graph, conn, part, wdeg, k) -> torch.Tensor:
    """Exact cut of `part` from its conn table: sum over real nodes of
    (weighted degree - connection to own block), halved."""
    is_real = graph.node_ids() < graph.n
    ext = torch.where(is_real, wdeg - _conn_own(conn, part, k), 0)
    return torch.div(ext.sum(dtype=ACC_DTYPE), 2, rounding_mode="floor")


def _scatter_conn_delta_cols(conn, old_b, new_b, dst_b, w_b, k, n_pad):
    """Apply a bulk-move delta to the conn table: for each slot (u, v)
    with u moved a -> b, conn[v, a] -= w and conn[v, b] += w (exact)."""
    flat_old = dst_b.to(torch.int64) * k + old_b.clamp(0, k - 1)
    flat_new = dst_b.to(torch.int64) * k + new_b.clamp(0, k - 1)
    flat = conn.reshape(-1).clone()
    flat.index_add_(0, flat_old, -w_b)
    flat.index_add_(0, flat_new, w_b)
    return flat.view(n_pad, k)


def _conn_update_rows(graph, conn, part_before, part_after, k, dslots):
    """Re-scatter the changed nodes' rows into the conn table."""
    n_pad = graph.n_pad
    changed = part_before != part_after
    owner_c, _, edge_id, valid, _, _ = expand_active_rows(
        graph.row_ptr, graph.degrees, changed, dslots
    )
    eid = edge_id.clamp(0, graph.src.shape[0] - 1)
    dst_b = torch.where(valid, gather_i32(graph.dst, eid), n_pad - 1)
    w_b = torch.where(valid, gather_i32(graph.edge_w, eid), 0).to(ACC_DTYPE)
    pb_c = part_before.clamp(0, k - 1)
    pa_c = part_after.clamp(0, k - 1)
    pba = (pb_c * k + pa_c)[owner_c]
    return _scatter_conn_delta_cols(
        conn, torch.div(pba, k, rounding_mode="floor"), pba % k, dst_b, w_b,
        k, n_pad,
    )


def _conn_step(graph, conn, before, after, k, dslots):
    if dslots is None:
        return _full_ratings(graph, after, k)
    changed_edges = int(
        torch.where(before != after, graph.degrees, 0).sum(dtype=torch.int32)
    )
    if changed_edges <= dslots:
        return _conn_update_rows(graph, conn, before, after, k, dslots)
    return _full_ratings(graph, after, k)


def _overload(graph, p, k, max_block_weights) -> int:
    bw = segment_sum(graph.node_w.to(ACC_DTYPE), p, k)
    return int((bw - max_block_weights).clamp(min=0).sum(dtype=ACC_DTYPE))


def _jet_iteration(
    graph: DeviceGraph,
    part: torch.Tensor,
    lock: torch.Tensor,
    k: int,
    max_block_weights: torch.Tensor,
    gain_temp: torch.Tensor,
    salt: int,
    balancer_rounds: int,
    wdeg: torch.Tensor,
    conn: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One Jet move round.  Returns (new_part, new_lock, ext_sum,
    new_conn): ext_sum = 2 * cut of the INPUT partition, and new_conn the
    conn table of the output partition (bitwise a full rebuild)."""
    n_pad = graph.n_pad
    is_real = graph.node_ids() < graph.n
    dslots = _delta_slots(graph)
    zeros_k = torch.zeros(k, dtype=ACC_DTYPE, device=graph.device)
    best, best_conn, conn_own = best_from_dense(
        conn, part, zeros_k, graph.node_w, zeros_k, salt, require_fit=False
    )
    ext_sum = torch.where(is_real, wdeg - conn_own, 0).sum(dtype=ACC_DTYPE)
    gain = best_conn - conn_own
    threshold = (-torch.floor(gain_temp * conn_own.to(torch.float32))).to(
        torch.int32
    )
    candidate = is_real & (best >= 0) & (lock == 0) & (gain > threshold)

    if dslots is None:
        next_part = torch.where(candidate, best, part)
        adj_gain = packed_afterburner_gain(
            graph.src, graph.dst, graph.edge_w, graph.row_ptr,
            part, next_part, gain, candidate, k,
        )
    else:
        candidate = prune_candidates_to_budget(
            candidate, gain, graph.degrees, salt ^ 0x5BD1E995, dslots
        )
        next_part = torch.where(candidate, best, part)
        owner_c, _, edge_id, valid, start, end = expand_active_rows(
            graph.row_ptr, graph.degrees, candidate, dslots
        )
        eid = edge_id.clamp(0, graph.src.shape[0] - 1)
        dst_b = torch.where(valid, gather_i32(graph.dst, eid), n_pad - 1)
        w_b = torch.where(valid, gather_i32(graph.edge_w, eid), 0)
        adj_gain, from_u, to_u = packed_afterburner_gain_rows(
            owner_c, dst_b, w_b, start, end,
            part, next_part, gain, candidate, k,
        )
    accept = candidate & (adj_gain > 0)
    new_part = torch.where(accept, next_part, part)
    new_lock = accept.to(torch.int32)

    if dslots is None:
        jet_conn = _conn_step(graph, conn, part, new_part, k, dslots)
    else:
        acc_o = accept[owner_c]
        w_m = torch.where(acc_o, w_b, 0).to(ACC_DTYPE)
        new_b = torch.where(acc_o, to_u, from_u)
        jet_conn = _scatter_conn_delta_cols(
            conn, from_u, new_b, dst_b, w_m, k, n_pad
        )

    # rebalance from the (stale within the loop) post-move table
    bal_part = new_part
    moved = 1
    i = 0
    while (
        i < balancer_rounds
        and _overload(graph, bal_part, k, max_block_weights) > 0
        and moved != 0
    ):
        s = (salt + i * 7919) & 0x7FFFFFFF
        bal_part, moved_t = overload_balance_round(
            graph, bal_part, k, max_block_weights, s, conn=jet_conn
        )
        moved = int(moved_t)
        i += 1
    if bool((bal_part != new_part).any()):
        new_conn = _conn_step(graph, jet_conn, new_part, bal_part, k, dslots)
    else:
        new_conn = jet_conn
    return bal_part, new_lock, ext_sum, new_conn


def _feasible(graph, p, k, max_block_weights) -> torch.Tensor:
    bw = segment_sum(graph.node_w.to(ACC_DTYPE), p, k)
    return (bw <= max_block_weights).all()


def _improved_enough(best_cut: int, cut: int, threshold: np.float32) -> bool:
    """float32 `(best_cut - cut) > (1 - threshold) * |best_cut|`."""
    diff = np.int32(np.int64(best_cut - cut).astype(np.int32))
    rhs = (np.float32(1.0) - threshold) * np.float32(abs(best_cut))
    return bool(np.float32(diff) > rhs)


def _jet_refine_impl(
    graph: DeviceGraph,
    partition: torch.Tensor,
    k: int,
    max_block_weights: torch.Tensor,
    seed: int,
    initial_gain_temp: np.float32,
    final_gain_temp: np.float32,
    fruitless_threshold: np.float32,
    num_rounds: int,
    max_iterations: int,
    max_fruitless: int,
    balancer_rounds: int,
    chunk: int = 4,
) -> torch.Tensor:
    dev = graph.device
    max_block_weights = max_block_weights.to(ACC_DTYPE)
    # static per-node weighted degree: each iteration's table then yields
    # the visited partition's exact cut
    csum = torch.cumsum(graph.edge_w.to(ACC_DTYPE), 0, dtype=ACC_DTYPE)
    csum0 = torch.cat([csum.new_zeros(1), csum])
    rp = graph.row_ptr.clamp(0, graph.edge_w.shape[0])
    wdeg = csum0[rp[1:]] - csum0[rp[:-1]]

    part = partition.clamp(0, k - 1).to(torch.int32)
    conn = _full_ratings(graph, part, k)
    cut0, feas0 = (
        int(v) for v in torch.stack([
            _conn_cut(graph, conn, part, wdeg, k),
            _feasible(graph, part, k, max_block_weights).to(ACC_DTYPE),
        ]).tolist()
    )
    best_cut = cut0 if feas0 else INT32_MAX
    best = part
    m_pad = graph.src.shape[0]
    if m_pad > MAX_FUSED_EDGE_SLOTS:
        chunk = 1
    elif m_pad > MAX_FUSED_EDGE_SLOTS // 2:
        chunk = min(chunk, 2)

    def close_round(part, best, best_cut, conn):
        cut, feas = (
            int(v) for v in torch.stack([
                _conn_cut(graph, conn, part, wdeg, k),
                _feasible(graph, part, k, max_block_weights).to(ACC_DTYPE),
            ]).tolist()
        )
        if cut <= best_cut and feas:
            return part, cut
        return best, best_cut

    for rnd in range(num_rounds):
        if num_rounds > 1:
            gain_temp = initial_gain_temp + (
                final_gain_temp - initial_gain_temp
            ) * np.float32(rnd) / np.float32(max(num_rounds - 1, 1))
        else:
            gain_temp = initial_gain_temp
        gain_temp_t = torch.tensor(np.float32(gain_temp), device=dev)
        lock = torch.zeros(graph.n_pad, dtype=torch.int32, device=dev)
        fruitless = 0
        if conn is None:
            conn = _full_ratings(graph, part, k)
        i = 0
        closed = False
        while i < max_iterations:
            limit = min(chunk, max_iterations - i)
            j = 0
            while j < limit and fruitless < max_fruitless:
                it = i + j
                salt = (
                    int(seed) * 31321 + rnd * 2221 + it * 1566083941
                ) & 0x7FFFFFFF
                new_part, lock, ext_sum, conn = _jet_iteration(
                    graph, part, lock, k, max_block_weights, gain_temp_t,
                    salt, balancer_rounds, wdeg, conn,
                )
                ext, feas = (
                    int(v) for v in torch.stack([
                        ext_sum,
                        _feasible(graph, part, k,
                                  max_block_weights).to(ACC_DTYPE),
                    ]).tolist()
                )
                cut = ext // 2
                if best_cut < INT32_MAX:
                    improved = _improved_enough(
                        best_cut, cut, fruitless_threshold
                    )
                else:
                    improved = bool(feas)
                fruitless = 0 if improved else fruitless + 1
                if cut <= best_cut and feas:
                    best, best_cut = part, cut
                part = new_part
                j += 1
            i += chunk
            if max_fruitless < max_iterations and fruitless >= max_fruitless:
                prev_best = best_cut
                best, best_cut = close_round(part, best, best_cut, conn)
                closed = True
                if best_cut < prev_best and i < max_iterations:
                    fruitless = 0
                    closed = False
                    continue
                break
        if not closed:
            best, best_cut = close_round(part, best, best_cut, conn)
        # rollback to the best partition seen (jet_refiner.cc:221-227)
        if best is not part and bool((part != best).any()):
            conn = None
        part = best
    return best


def jet_refine(
    graph: DeviceGraph,
    partition: torch.Tensor,
    k: int,
    max_block_weights: torch.Tensor,
    seed: int,
    ctx: JetRefinementContext,
    level: int = 0,
    num_levels: int = 1,
    balancer_rounds: int = 4,
) -> torch.Tensor:
    """Jet refinement entry point; coarse/fine temperatures by level
    (every level except the finest counts as coarse)."""
    if graph.n_pad * k > JET_DENSE_MAX_ENTRIES:
        # the dense conn table would not fit: degrade to LP refinement
        from .lp import LPConfig, lp_refine

        cfg = LPConfig(
            num_iterations=8, participation=1.0, allow_tie_moves=False,
            use_active_set=True, refinement=True,
        )
        return lp_refine(graph, partition, k, max_block_weights, seed, cfg)
    is_coarse = level > 0
    if is_coarse:
        rounds = ctx.num_rounds_on_coarse_level
        t0 = ctx.initial_gain_temp_on_coarse_level
        t1 = ctx.final_gain_temp_on_coarse_level
    else:
        rounds = ctx.num_rounds_on_fine_level
        t0 = ctx.initial_gain_temp_on_fine_level
        t1 = ctx.final_gain_temp_on_fine_level
    if ctx.num_iterations > 0:
        max_iterations = ctx.num_iterations
    elif is_coarse:
        max_iterations = (
            8 if graph.src.shape[0] >= DELTA_MIN_EDGE_SLOTS else 16
        )
    else:
        max_iterations = 8
    max_fruitless = (
        ctx.num_fruitless_iterations
        if ctx.num_fruitless_iterations > 0
        else 2**30
    )
    return _jet_refine_impl(
        graph, partition, k, max_block_weights, seed,
        np.float32(t0), np.float32(t1), np.float32(ctx.fruitless_threshold),
        int(rounds), int(max_iterations), int(max_fruitless),
        int(balancer_rounds),
    )
