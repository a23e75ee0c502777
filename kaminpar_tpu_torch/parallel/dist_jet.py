"""Distributed Jet refinement over the shard mesh (counterpart of
kaminpar_tpu/parallel/dist_jet.py, the reference's dist jet_refiner.cc).

The partition is owner-sharded (each shard's owned blocks and ghost
blocks).  An iteration: every shard finds its candidate moves from its
edge shard and ghost blocks (K1 gathers the neighbour blocks); one halo
exchange publishes the interface nodes' (candidate gain, destination)
for the afterburner; accepted moves apply locally and a second halo
exchange republishes the blocks; the distributed node balancer runs to
feasibility (dist_balancer.dist_balance_round); the psum'd cut keeps the
best feasible partition, which each round ends on.  Loop predicates are
read back once per step for all shards.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..context import JetRefinementContext
from ..dtypes import ACC_DTYPE, INT32_MAX, INT32_MIN
from ..ops.gather import gather_i32
from ..ops.segments import (
    aggregate_by_key,
    argmax_per_segment,
    connection_to_label,
    segment_sum,
)
from .dist_balancer import BalanceState, dist_balance_round
from .dist_graph import DistGraph
from .mesh import account_collective, halo_exchange, psum

_I32 = torch.int32


def _local_cut(st: BalanceState) -> torch.Tensor:
    """The global cut of the owner-sharded state (every undirected edge is
    stored at both endpoints: the psum counts a cut edge twice)."""
    n_loc = st.graph.n_loc
    locals_ = []
    for sh, part, ghost, seg, dl in zip(st.shards, st.parts, st.ghosts,
                                        st.segs, st.dstlocs):
        tab = torch.cat([part, ghost])
        own = part[seg.clamp(0, n_loc - 1).long()]
        nb = gather_i32(tab, dl)
        locals_.append(torch.where(own != nb, sh.edge_w, 0).sum(
            dtype=ACC_DTYPE))
    account_collective("psum(cut)", 4, shape=())
    return psum(locals_, device=st.graph.mesh.device) // 2


def _feasible(st: BalanceState, k: int, cap: torch.Tensor) -> torch.Tensor:
    return (st.block_weights(k) <= cap).all()


def _jet_iteration(st: BalanceState, locks: List[torch.Tensor], k: int,
                   gain_temp: torch.Tensor, salt: int) -> List[torch.Tensor]:
    """One find / filter / execute step over every shard; updates `st` and
    returns the new locks."""
    graph = st.graph
    n_loc, g_loc, n = graph.n_loc, graph.g_loc, graph.n
    found = []
    for d, sh in enumerate(st.shards):
        part, seg, dl = st.parts[d], st.segs[d], st.dstlocs[d]
        tab = torch.cat([part, st.ghosts[d]])
        nb = gather_i32(tab, dl)
        seg_g, key_g, w_g = aggregate_by_key(seg, nb, sh.edge_w)
        sgc = seg_g.clamp(0, n_loc - 1)
        is_ext = (seg_g >= 0) & (key_g != part[sgc])
        best, best_conn = argmax_per_segment(seg_g, key_g, w_g, n_loc,
                                             tie_salt=salt, feasible=is_ext)
        conn_own = connection_to_label(seg_g, key_g, w_g, part, n_loc)
        gain = best_conn - conn_own
        threshold = (-torch.floor(
            gain_temp.to(part.device) * conn_own.to(torch.float32))).to(_I32)
        candidate = ((st.ids[d] < n) & (best >= 0) & (locks[d] == 0)
                     & (gain > threshold))
        next_part = torch.where(candidate, best, part).to(_I32)
        gain_cand = torch.where(candidate, gain, INT32_MIN).to(_I32)
        found.append((tab, nb, candidate, next_part, gain_cand))
    send = [sh.send_idx for sh in st.shards]
    recv = [sh.recv_map for sh in st.shards]
    ghosts = halo_exchange([torch.stack([f[4], f[3]]) for f in found], send,
                           recv, g_loc)
    new_parts, new_locks = [], []
    for d, sh in enumerate(st.shards):
        tab, nb, candidate, next_part, gain_cand = found[d]
        part, seg, dl = st.parts[d], st.segs[d], st.dstlocs[d]
        seg_c = seg.clamp(0, n_loc - 1)
        gain_tab = torch.cat([gain_cand, ghosts[d][0]])
        next_tab = torch.cat([next_part, ghosts[d][1]])
        gain_u = gain_cand[seg_c.long()]
        gain_v = gather_i32(gain_tab, dl)
        v_before_u = (gain_v > INT32_MIN) & (
            (gain_v > gain_u) | ((gain_v == gain_u) & (sh.dst < sh.src)))
        block_v = torch.where(v_before_u, gather_i32(next_tab, dl), nb)
        to_u = next_part[seg_c.long()]
        from_u = part[seg_c.long()]
        ew = sh.edge_w
        contrib = torch.where(to_u == block_v, ew,
                              torch.where(from_u == block_v, -ew, 0))
        adj_gain = segment_sum(
            torch.where(candidate[seg_c.long()], contrib, 0).to(ACC_DTYPE),
            seg_c, n_loc)
        accept = candidate & (adj_gain > 0)
        new_parts.append(torch.where(accept, next_part, part))
        new_locks.append(accept.to(_I32))
    st.ghosts = halo_exchange(new_parts, send, recv, g_loc)
    st.parts = new_parts
    return new_locks


def _improved_enough(best_cut: int, cut: int, threshold: np.float32) -> bool:
    """float32 `(best_cut - cut) > (1 - threshold) * |best_cut|`."""
    diff = np.int64(best_cut - cut).astype(np.int32)
    rhs = (np.float32(1.0) - threshold) * np.float32(abs(best_cut))
    return bool(np.float32(diff) > rhs)


def _dist_jet(graph: DistGraph, partition: torch.Tensor, k: int,
              cap: torch.Tensor, seed: int, initial_gain_temp: np.float32,
              final_gain_temp: np.float32, fruitless_threshold: np.float32,
              num_rounds: int, max_iterations: int, max_fruitless: int,
              balancer_rounds: int) -> torch.Tensor:
    home = graph.mesh.device
    st = BalanceState(graph, partition.clamp(0, k - 1))
    n_loc = graph.n_loc
    cut0, feas0 = torch.stack([_local_cut(st),
                               _feasible(st, k, cap).to(ACC_DTYPE)]).tolist()
    best_cut = cut0 if feas0 else INT32_MAX
    best = list(st.parts)
    for rnd in range(num_rounds):
        if num_rounds > 1:
            gain_temp = initial_gain_temp + (
                final_gain_temp - initial_gain_temp
            ) * np.float32(rnd) / np.float32(max(num_rounds - 1, 1))
        else:
            gain_temp = initial_gain_temp
        gain_temp_t = torch.tensor(np.float32(gain_temp), device=home)
        locks = [torch.zeros(n_loc, dtype=_I32, device=p.device)
                 for p in st.parts]
        i, fruitless = 0, 0
        while i < max_iterations and fruitless < max_fruitless:
            salt = (int(seed) * 31321 + rnd * 2221
                    + i * 1566083941) & 0x7FFFFFFF
            locks = _jet_iteration(st, locks, k, gain_temp_t, salt)
            # the balancer runs to feasibility or a dry round
            j, moved = 0, 1
            still = not bool(_feasible(st, k, cap))
            while j < 4 * balancer_rounds and moved != 0 and still:
                s = (salt + j * 7919) & 0x7FFFFFFF
                moved_t, still_t = dist_balance_round(st, k, cap, s)
                moved, still = torch.stack(
                    [moved_t, still_t.to(_I32)]).tolist()
                j += 1
            cut, feas = torch.stack([
                _local_cut(st), _feasible(st, k, cap).to(ACC_DTYPE)
            ]).tolist()
            if best_cut < INT32_MAX:
                improved = _improved_enough(best_cut, cut,
                                            fruitless_threshold)
            else:
                improved = bool(feas)
            fruitless = 0 if improved else fruitless + 1
            if cut <= best_cut and feas:
                best, best_cut = list(st.parts), cut
            i += 1
        # each round ends on the best partition, ghosts re-synced from it
        st.parts = list(best)
        st.ghosts = halo_exchange(st.parts,
                                  [sh.send_idx for sh in st.shards],
                                  [sh.recv_map for sh in st.shards],
                                  graph.g_loc)
    return st.gather()


def dist_jet_refine(graph: DistGraph, partition, k: int, max_block_weights,
                    seed, ctx: Optional[JetRefinementContext] = None,
                    level: int = 0, balancer_rounds: int = 4
                    ) -> torch.Tensor:
    """Distributed Jet refinement; the temperature schedule is picked by
    level as in the shared-memory Jet.  Returns the gathered partition."""
    if ctx is None:
        ctx = JetRefinementContext()
    if level > 0:
        rounds = ctx.num_rounds_on_coarse_level
        t0 = ctx.initial_gain_temp_on_coarse_level
        t1 = ctx.final_gain_temp_on_coarse_level
    else:
        rounds = ctx.num_rounds_on_fine_level
        t0 = ctx.initial_gain_temp_on_fine_level
        t1 = ctx.final_gain_temp_on_fine_level
    max_iterations = ctx.num_iterations if ctx.num_iterations > 0 else 64
    max_fruitless = (ctx.num_fruitless_iterations
                     if ctx.num_fruitless_iterations > 0 else 2**30)
    home = graph.mesh.device
    return _dist_jet(
        graph, torch.as_tensor(partition).to(home).to(_I32), k,
        torch.as_tensor(max_block_weights).to(home).to(ACC_DTYPE), int(seed),
        np.float32(t0), np.float32(t1), np.float32(ctx.fruitless_threshold),
        int(rounds), int(max_iterations), int(max_fruitless),
        int(balancer_rounds),
    )


__all__ = ["dist_jet_refine"]
